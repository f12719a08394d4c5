"""The port's edge stores and update traces against the JAX package:
``EdgeStore`` slot for slot (build with duplicates and self-loops, staged
inserts, reweights and deletes, LIFO recycling, capacity growth, the
device arrays after each flush, ``uploads`` and ``scatters``, its state
tree and ``from_state``, ``drop_device``), ``GraphStore`` at 1, 2 and 4
shards with and without pilot centers and compression (slabs, halo index,
``halo_k``, byte counts, ``perm``, state trees; mutation drops the layout;
a mismatched geometry is refused), and ``temporal_trace`` batch for batch
(every mix, both insert modes, a graph of 20,000 nodes). Every compared
value is an integer, so every comparison is exact."""
import torch_testing  # noqa: F401  (first: one thread, the x64 shim)

import dataclasses

import jax

import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

from repro.graph import generators as ref_gen  # noqa: E402
from repro.graph.storage import EdgeStore as RefStore  # noqa: E402
from repro.graph.storage import GraphStore as RefGraphStore  # noqa: E402
from repro.graph.structures import EdgeList as RefEdgeList  # noqa: E402
from repro_torch.graph import (  # noqa: E402
    EDGE_STORE_BUCKET,
    EdgeStore,
    GraphStore,
)
from repro_torch.runtime.compression import PackedI32  # noqa: E402
from repro_torch.graph import generators as gen  # noqa: E402
from repro_torch.graph.structures import EdgeList  # noqa: E402

CPU = torch.device("cpu")


def _pair(n, src, dst, w, **kw):
    src, dst, w = (np.asarray(x, np.int32) for x in (src, dst, w))
    return (RefStore(RefEdgeList(n, src, dst, w), **kw),
            EdgeStore(EdgeList(n, src, dst, w), device=CPU, **kw))


def _same(ref: RefStore, port: EdgeStore) -> None:
    for name in ("h_src", "h_dst", "h_weight", "valid"):
        np.testing.assert_array_equal(getattr(port, name), getattr(ref, name))
    assert port.slot_of == ref.slot_of
    assert list(port.slot_of) == list(ref.slot_of)
    assert port.free == ref.free
    assert (port.capacity, port.n_edges) == (ref.capacity, ref.n_edges)
    for name in ("src", "dst", "weight"):
        t = getattr(port, name)
        assert t.dtype == torch.int32 and t.device == CPU
        np.testing.assert_array_equal(t.numpy(), np.asarray(getattr(ref, name)))
    assert (port.uploads, port.scatters) == (ref.uploads, ref.scatters)
    e_r, e_p = ref.edge_list(), port.edge_list()
    for name in ("src", "dst", "weight"):
        np.testing.assert_array_equal(getattr(e_p, name), getattr(e_r, name))


def test_edge_store_build_coalesces_and_drops_self_loops():
    """Duplicates keep their least weight, self-loops become free slots,
    and the slots are the reference's, (dst, src)-sorted."""
    ref, port = _pair(5, [0, 0, 2, 1, 3, 4, 3], [1, 1, 2, 0, 4, 3, 4],
                      [7, 3, 9, 5, 2, 8, 1], headroom=1.0, bucket=4)
    _same(ref, port)
    assert port.n_edges == 4 and port.lookup(0, 1) == 3
    assert port.lookup(3, 4) == 1 and port.lookup(2, 2) is None


@pytest.mark.parametrize("headroom,bucket", [(1.5, EDGE_STORE_BUCKET),
                                             (1.0, 8)])
def test_edge_store_mutations_match_the_reference(headroom, bucket):
    """Inserts, reweights and deletes flushed in rounds (in-place scatters),
    slots recycled last-freed first, then inserts past the headroom (a
    capacity growth and a whole upload)."""
    g = ref_gen.random_geometric(120, seed=3)
    ref, port = _pair(g.n_nodes, g.src, g.dst, g.weight, headroom=headroom,
                      bucket=bucket)
    _same(ref, port)
    rng = np.random.default_rng(0)
    keys = list(ref.slot_of)
    for rnd in range(4):
        dels = [keys[i] for i in rng.choice(len(keys), 6, replace=False)]
        for s in (ref, port):
            for u, v in dels:
                s.delete_edge(u, v)
        keys = [k for k in keys if k not in dels]
        adds = []
        while len(adds) < 4 + 20 * (rnd == 3):
            u, v = map(int, rng.integers(0, g.n_nodes, 2))
            if u != v and (u, v) not in keys and (u, v) not in adds:
                adds.append((u, v))
        for s in (ref, port):
            for i, (u, v) in enumerate(adds):
                s.set_edge(u, v, 1 + i)
            s.set_edge(*keys[0], 77)
        keys += adds
        assert port.flush() == ref.flush()
        _same(ref, port)
    assert port.flush() is False and port.scatters == ref.scatters


def test_edge_store_refusals_leave_it_untouched():
    e = gen.grid_mesh(4, "unit")
    port = EdgeStore(e, device=CPU)
    before = (port.h_src.copy(), port.free.copy(), dict(port.slot_of))
    with pytest.raises(ValueError, match="headroom"):
        EdgeStore(e, headroom=0.5, device=CPU)
    with pytest.raises(ValueError, match="out of range"):
        port.set_edge(0, 99, 3)
    with pytest.raises(ValueError, match=r"\[1, 2\^30\)"):
        port.set_edge(0, 1, 0)
    with pytest.raises(ValueError, match="missing edge"):
        port.delete_edge(0, 15)
    np.testing.assert_array_equal(port.h_src, before[0])
    assert port.free == before[1] and port.slot_of == before[2]


def _same_batches(ref_batches, port_batches):
    assert len(ref_batches) == len(port_batches)
    for a, b in zip(ref_batches, port_batches):
        for f in dataclasses.fields(a):
            x, y = getattr(a, f.name), getattr(b, f.name)
            assert y.dtype == np.int32
            np.testing.assert_array_equal(y, x)


@pytest.mark.parametrize("insert_mode", ["local", "random"])
@pytest.mark.parametrize("mix", [(1.0, 0.0, 0.0), (0.4, 0.4, 0.2),
                                 (0.1, 0.1, 0.8)])
@pytest.mark.parametrize("family", ["road", "social", "mesh"])
def test_temporal_trace_matches_the_reference(family, mix, insert_mode):
    make = {"road": lambda m: m.road_like(300, seed=2),
            "social": lambda m: m.social_like(8, seed=1),
            "mesh": lambda m: m.grid_mesh(9, "uniform", seed=4, high=50)}
    kw = dict(events_per_batch=25, p_insert=mix[0], p_reweight=mix[1],
              p_delete=mix[2], insert_mode=insert_mode, seed=5)
    _same_batches(ref_gen.temporal_trace(make[family](ref_gen), 4, **kw),
                  gen.temporal_trace(make[family](gen), 4, **kw))


def test_temporal_trace_at_20000_nodes():
    """The key sets' iteration order (what ``live`` inherits) holds at a
    size where the hash tables have resized many times."""
    kw = dict(events_per_batch=400, seed=1)
    _same_batches(ref_gen.temporal_trace(ref_gen.road_like(20_000), 3, **kw),
                  gen.temporal_trace(gen.road_like(20_000), 3, **kw))


def test_temporal_trace_refusals():
    g = gen.road_like(50)
    for kw, msg in ((dict(n_batches=-1), "n_batches"),
                    (dict(n_batches=1, insert_mode="far"), "insert_mode"),
                    (dict(n_batches=1, p_insert=0, p_reweight=0,
                          p_delete=0), "positive")):
        with pytest.raises(ValueError, match=msg):
            gen.temporal_trace(g, **kw)
    with pytest.raises(ValueError, match=">= 2 nodes"):
        gen.temporal_trace(EdgeList(1, [], [], []), 1)
    assert gen.temporal_trace(g, 0) == []


# ---------------------------------------------------------------------------
# the state seam and the partition-aware GraphStore
# ---------------------------------------------------------------------------


def _same_tree(port_tree, ref_tree):
    assert list(port_tree) == list(ref_tree)
    for k in ref_tree:
        a, b = np.asarray(port_tree[k]), np.asarray(ref_tree[k])
        assert a.dtype == b.dtype, k
        np.testing.assert_array_equal(a, b)


def test_edge_store_state_round_trip_matches_reference():
    """The state tree (free list in order, full capacity) and extra equal
    the reference's after mutations; ``from_state`` rebuilds the same
    store on the device (one upload); ``drop_device`` / ``ensure_device``
    give the memory back and upload again."""
    g = ref_gen.random_geometric(150, seed=4)
    ref, port = _pair(g.n_nodes, g.src, g.dst, g.weight, headroom=1.5,
                      bucket=64)
    for st in (ref, port):
        st.delete_edge(int(g.src[0]), int(g.dst[0]))
        st.set_edge(3, 77, 9)
        st.flush()
    _same_tree(port.state_dict(), ref.state_dict())
    assert port.extra_state() == ref.extra_state()
    p2 = EdgeStore.from_state(port.state_dict(), port.extra_state(),
                              device=CPU)
    r2 = RefStore.from_state(ref.state_dict(), ref.extra_state())
    _same(r2, p2)
    assert p2.device_bytes() == 3 * 4 * len(p2.h_src)
    p2.drop_device()
    assert p2.src is None and p2.dst is None and p2.weight is None
    assert p2.device_bytes() == 0
    p2.ensure_device()
    assert p2.uploads == 2
    assert p2.device_bytes() == 3 * 4 * len(p2.h_src)
    np.testing.assert_array_equal(p2.src.numpy(), p2.h_src)
    with pytest.raises(ValueError, match="n_nodes"):
        p2.load_state(port.state_dict(), {**port.extra_state(),
                                          "n_nodes": 3})


def _graph_store_pair(n_shards, with_centers, compress, n=700):
    r = ref_gen.random_geometric(n, avg_degree=4.0, seed=2)
    centers = (np.random.default_rng(5).integers(0, 40, n)
               if with_centers else None)
    kw = dict(n_shards=n_shards, centers=centers, compress=compress)
    return (RefGraphStore(r, **kw),
            GraphStore(EdgeList(n, r.src, r.dst, r.weight), device=CPU, **kw))


def _same_layout(ref, port):
    for name in ("n_pad", "nodes_per_shard", "capacity", "n_edges"):
        assert getattr(port, name) == getattr(ref, name), name
    for name in ("perm", "inv_perm"):
        a, b = getattr(port, name), getattr(ref, name)
        assert (a is None) == (b is None)
        if a is not None:
            np.testing.assert_array_equal(a, b)
    assert len(port.slabs()) == len(ref.slabs())
    for ps, rs in zip(port.slabs(), ref.slabs()):
        assert (ps.shard, ps.n_edges, ps.compressed, ps.nbytes) == (
            rs.shard, rs.n_edges, rs.compressed, rs.nbytes)
        for col in ("src", "dst", "weight"):
            a, b = getattr(ps, col), getattr(rs, col)
            if ps.compressed:
                assert isinstance(a, PackedI32)
                assert a.data.dtype == b.data.dtype
                assert a.data.tobytes() == b.data.tobytes()
                assert (a.n, a.first) == (b.n, b.first)
            else:
                np.testing.assert_array_equal(a, b)
    assert sorted(port.halo_index()) == sorted(ref.halo_index())
    for p in ref.halo_index():
        np.testing.assert_array_equal(port.halo_index()[p],
                                      ref.halo_index()[p])
    for name in ("halo_k", "halo_rows", "halo_bytes_per_superstep",
                 "fullplane_bytes_per_superstep", "resident_bytes",
                 "raw_bytes"):
        assert getattr(port, name)() == getattr(ref, name)(), name
    for p in range(ref.n_shards):
        for a, b in zip(port.slab(p), ref.slab(p)):
            assert a.dtype == np.int32
            np.testing.assert_array_equal(a, b)
    assert port.decompressions == ref.decompressions
    _same_tree(port.state_dict(), ref.state_dict())
    assert port.extra_state() == ref.extra_state()


@pytest.mark.parametrize("compress", [False, True])
@pytest.mark.parametrize("with_centers", [False, True])
@pytest.mark.parametrize("n_shards", [1, 2, 4])
def test_graph_store_matches_reference(n_shards, with_centers, compress):
    ref, port = _graph_store_pair(n_shards, with_centers, compress)
    _same_layout(ref, port)
    # the device arrays are the relabeled host mirrors
    np.testing.assert_array_equal(port.src.numpy(), np.asarray(ref.src))
    # from_state rebuilds the same store, relabeling included
    p2 = GraphStore.from_state(port.state_dict(), port.extra_state(),
                               device=CPU)
    r2 = RefGraphStore.from_state(ref.state_dict(), ref.extra_state())
    _same_layout(r2, p2)


def test_graph_store_mutation_invalidates_layout():
    """A staged insert or delete drops the slabs, the halo index and
    ``halo_k``; so does a flush that grew the capacity; the layout built
    again equals the reference's after the same mutations."""
    ref, port = _graph_store_pair(4, True, True)
    _same_layout(ref, port)
    far = [(u, (u + off) % 700) for off in range(348, 354) for u in range(700)]
    for st in (ref, port):
        st.set_edge(0, 500, 7)
        assert st._slabs is None and st._halo is None and st._halo_k is None
        st.flush()
        st.slabs()
        st.delete_edge(0, 500)
        assert st._slabs is None
        st.flush()
        cap = st.capacity
        for u, v in far:       # more inserts than free slots: a growth
            if st.lookup(u, v) is None:
                st.set_edge(u, v, 3)
        assert st.capacity > cap
        st.slabs()
        assert st.flush() and st._slabs is None
    _same_layout(ref, port)


def test_graph_store_refuses_mismatched_geometry():
    ref, port = _graph_store_pair(4, False, False)
    two = GraphStore(port.edge_list(), n_shards=2, device=CPU)
    with pytest.raises(ValueError, match="n_shards"):
        two.load_state(port.state_dict(), port.extra_state())
    with pytest.raises(ValueError, match="n_shards"):
        RefGraphStore(ref.edge_list(), n_shards=2).load_state(
            ref.state_dict(), ref.extra_state())
    with pytest.raises(ValueError, match="n_shards"):
        GraphStore(port.edge_list(), n_shards=0, device=CPU)
    with pytest.raises(NotImplementedError, match="item 7"):
        port.sharded_graph()
