"""The port's mutable edge store and update traces against the JAX package:
``EdgeStore`` slot for slot (build with duplicates and self-loops, staged
inserts, reweights and deletes, LIFO recycling, capacity growth, the
device arrays after each flush, ``uploads`` and ``scatters``) and
``temporal_trace`` batch for batch (every mix, both insert modes, a graph
of 20,000 nodes). Every compared value is an integer, so every comparison
is exact."""
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

import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

from repro.graph import generators as ref_gen  # noqa: E402
from repro.graph.storage import EdgeStore as RefStore  # noqa: E402
from repro.graph.structures import EdgeList as RefEdgeList  # noqa: E402
from repro_torch.graph import EDGE_STORE_BUCKET, EdgeStore  # noqa: E402
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
