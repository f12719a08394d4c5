"""The port's node partitions and int32 column codec against the JAX
package: ``range_partition``, ``cluster_partition`` (the contiguous fill
and the LPT fill it falls back to), ``apply_partition``,
``partition_for_backend`` and ``cut_fraction`` give the reference's arrays
and numbers; ``pack_i32`` gives the reference's bytes at the reference's
width, and ``unpack_i32`` inverts it exactly, int32 extremes included."""

import torch_testing  # noqa: F401  (first: one thread, the x64 shim)

import jax

import numpy as np  # noqa: E402
import pytest  # noqa: E402

from repro.graph import generators as ref_gen  # noqa: E402
from repro.graph import partition as ref_part  # noqa: E402
from repro.graph.structures import EdgeList as RefEdgeList  # noqa: E402
from repro.runtime.compression import pack_i32 as ref_pack  # noqa: E402
from repro_torch.graph import partition as part  # noqa: E402
from repro_torch.graph.structures import EdgeList  # noqa: E402
from repro_torch.runtime.compression import (  # noqa: E402
    PackedI32,
    pack_i32,
    unpack_i32,
)

# a size sequence whose contiguous fill exceeds 1.5x the LPT fill's max
# load on 4 shards (87 against 54), so cluster_partition takes LPT
LPT_SIZES = [38, 31, 16, 19, 3, 5, 1, 11, 48, 39]


def _centers(case: str) -> np.ndarray:
    rng = np.random.default_rng(7)
    if case == "random":
        return rng.integers(0, 40, 1000)
    if case == "skewed":
        sizes = [500, 100, 100, 100, 60, 50, 40, 30, 10, 10]
        return rng.permutation(np.repeat(np.arange(len(sizes)), sizes))
    if case == "lpt":
        return np.repeat(np.arange(len(LPT_SIZES)) * 3, LPT_SIZES)
    if case == "one_cluster":
        return np.full(50, 7)
    raise ValueError(case)


@pytest.mark.parametrize("n_devices", [1, 2, 4, 7])
@pytest.mark.parametrize("case", ["random", "skewed", "lpt", "one_cluster"])
def test_cluster_partition_matches_reference(case, n_devices):
    centers = _centers(case)
    perm = part.cluster_partition(centers, n_devices)
    ref = ref_part.cluster_partition(centers, n_devices)
    assert perm.dtype == np.int32
    np.testing.assert_array_equal(perm, ref)
    np.testing.assert_array_equal(part.range_partition(len(centers),
                                                       n_devices),
                                  ref_part.range_partition(len(centers),
                                                           n_devices))


def test_lpt_case_takes_the_lpt_fill():
    counts = np.asarray(LPT_SIZES)
    cont = part._contiguous_fill(counts, 4)
    lpt = part._lpt_fill(counts, 4)
    np.testing.assert_array_equal(cont, ref_part._contiguous_fill(counts, 4))
    np.testing.assert_array_equal(lpt, ref_part._lpt_fill(counts, 4))
    assert part._max_load(counts, cont, 4) > 1.5 * part._max_load(
        counts, lpt, 4)


@pytest.mark.parametrize("n_devices", [2, 4])
def test_apply_partition_cut_and_backend_choice(n_devices):
    """Relabeled edges, inverse permutation and cut fraction equal the
    reference's; only a sharded backend with a pilot gets the
    relabeling."""
    r = ref_gen.random_geometric(900, avg_degree=4.0, seed=2)
    g = EdgeList(r.n_nodes, r.src, r.dst, r.weight)
    centers = np.random.default_rng(3).integers(0, 60, g.n_nodes)
    perm = part.cluster_partition(centers, n_devices)
    g2, inv = part.apply_partition(g, perm)
    r2, rinv = ref_part.apply_partition(r, perm)
    for name in ("src", "dst", "weight"):
        np.testing.assert_array_equal(getattr(g2, name), getattr(r2, name))
    np.testing.assert_array_equal(inv, rinv)
    assert part.cut_fraction(g2, n_devices) == ref_part.cut_fraction(
        r2, n_devices)
    assert part.cut_fraction(g, n_devices) == ref_part.cut_fraction(
        r, n_devices)
    for backend, cs in (("sharded", centers), ("sharded", None),
                        ("single", centers), ("kernel", centers)):
        got = part.partition_for_backend(g, backend, n_devices, cs)
        want = ref_part.partition_for_backend(
            r, "pallas" if backend == "kernel" else backend, n_devices, cs)
        np.testing.assert_array_equal(got, want)
    empty = EdgeList(5, np.zeros(0, np.int32), np.zeros(0, np.int32),
                     np.zeros(0, np.int32))
    assert part.cut_fraction(empty, 2) == ref_part.cut_fraction(
        RefEdgeList(5, empty.src, empty.dst, empty.weight), 2) == 0.0


I32 = np.iinfo(np.int32)
COLUMNS = {
    "empty": np.zeros(0, np.int32),
    "one": np.array([-5], np.int32),
    "sorted": np.sort(np.random.default_rng(0).integers(0, 5000, 3000)),
    "small_deltas": np.cumsum(np.random.default_rng(1).integers(-100, 100,
                                                                500)),
    "wide_deltas": np.array([0, 40000, 0, -20000, 10], np.int32),
    "extremes": np.array([I32.min, I32.max, I32.min, 0, I32.max, -1,
                          I32.min + 1, I32.max - 1], np.int32),
    "constant": np.full(100, I32.max, np.int32),
}


@pytest.mark.parametrize("name", sorted(COLUMNS))
def test_pack_i32_matches_reference_bytes(name):
    x = np.asarray(COLUMNS[name], np.int32)
    p, r = pack_i32(x), ref_pack(x)
    assert isinstance(p, PackedI32)
    assert p.data.dtype == r.data.dtype
    assert p.data.tobytes() == r.data.tobytes()
    assert (p.n, p.first, p.nbytes) == (r.n, r.first, r.nbytes)
    out = unpack_i32(p)
    assert out.dtype == np.int32
    assert out.tobytes() == x.tobytes()


def test_pack_i32_widths_and_refusal():
    assert pack_i32(np.arange(300, dtype=np.int32)).data.dtype == np.uint8
    assert pack_i32(COLUMNS["wide_deltas"]).data.dtype == np.uint32
    assert pack_i32(np.array([0, 30000], np.int32)).data.dtype == np.uint16
    assert pack_i32(COLUMNS["extremes"]).data.dtype == np.uint64
    with pytest.raises(ValueError, match="1-d"):
        pack_i32(np.zeros((2, 2), np.int32))
