"""Node partitioning for sharded storage, the port of the JAX package's
``graph/partition.py``.

  * ``range_partition``: contiguous node ranges (the identity relabeling).
  * ``cluster_partition``: whole clusters of a CLUSTER decomposition packed
    onto shards, so most edges stay inside a shard and the halo (the rows
    that travel between shards) stays small.

Both return a permutation ``perm`` (new id -> old id) under which shard
``p`` owns the contiguous new ids ``[p*Q, (p+1)*Q)``. The arrays equal the
reference's.
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np

from repro_torch.common import ceil_div
from repro_torch.graph.structures import EdgeList


def range_partition(n_nodes: int, n_devices: int) -> np.ndarray:
    """The identity permutation: shard ``p`` owns a contiguous id range."""
    return np.arange(n_nodes, dtype=np.int32)


def _contiguous_fill(counts: np.ndarray, n_devices: int) -> np.ndarray:
    """Balanced CONTIGUOUS segmentation of the cluster sizes: clusters, in
    center-id order, fill device ``d`` until its load reaches
    ``total * (d+1) / P``, so the max load is at most
    ``total/P + max_cluster - 1``."""
    total = int(counts.sum())
    thresholds = (total * (np.arange(1, n_devices + 1))) // n_devices
    cum = np.cumsum(counts)
    return np.searchsorted(thresholds, cum, side="left").clip(
        max=n_devices - 1).astype(np.int64)


def _lpt_fill(counts: np.ndarray, n_devices: int) -> np.ndarray:
    """Largest-first greedy packing (LPT): each cluster, largest first
    (ties by center id), onto the least-loaded device (ties by device id);
    max load within 4/3 of the optimum."""
    order = np.argsort(-counts, kind="stable")
    loads = np.zeros(n_devices, dtype=np.int64)
    dev = np.zeros(len(counts), dtype=np.int64)
    for ci in order:
        d = int(np.argmin(loads))
        dev[ci] = d
        loads[d] += int(counts[ci])
    return dev


def _max_load(counts: np.ndarray, dev: np.ndarray, n_devices: int) -> int:
    return int(np.bincount(dev, weights=counts,
                           minlength=n_devices).max()) if len(counts) else 0


def cluster_partition(centers: np.ndarray, n_devices: int,
                      imbalance_tolerance: float = 1.5) -> np.ndarray:
    """Locality-preserving, load-balanced packing of clusters onto shards.

    ``centers[u]`` is node u's cluster center. A cluster never splits
    across shards. The contiguous fill keeps clusters in center-id order
    (neighbouring clusters share a shard); the LPT fill takes over when the
    contiguous max load exceeds ``imbalance_tolerance`` x LPT's. Every
    choice and tie-break is a function of ``centers``. Returns ``perm``
    (new -> old), shard ranges contiguous.
    """
    n = len(centers)
    centers = np.asarray(centers)
    _, inv_idx, counts = np.unique(centers, return_inverse=True,
                                   return_counts=True)
    dev_of_cluster = _contiguous_fill(counts, n_devices)
    lpt = _lpt_fill(counts, n_devices)
    if (_max_load(counts, dev_of_cluster, n_devices)
            > imbalance_tolerance * max(_max_load(counts, lpt, n_devices), 1)):
        dev_of_cluster = lpt
    dev_of_node = dev_of_cluster[inv_idx]
    # stable sort by (device, cluster, id): contiguous shard ranges with
    # whole clusters together
    return np.lexsort((np.arange(n), centers, dev_of_node)).astype(np.int32)


def apply_partition(edges: EdgeList,
                    perm: np.ndarray) -> Tuple[EdgeList, np.ndarray]:
    """Relabel node ids by ``perm`` (new -> old); returns
    ``(edges', inv_perm)``."""
    inv = np.empty_like(perm)
    inv[perm] = np.arange(len(perm), dtype=np.int32)
    return (EdgeList(edges.n_nodes, inv[edges.src], inv[edges.dst],
                     edges.weight), inv)


def partition_for_backend(edges: EdgeList, backend: str, n_devices: int,
                          centers: Optional[np.ndarray] = None) -> np.ndarray:
    """The relabeling a backend gets: only a sharded backend pays for edge
    cuts, so only it (with more than one device and a pilot's ``centers``)
    gets ``cluster_partition``; every other backend keeps the identity.
    The port has no sharded backend yet, so on the port this is always
    the identity, as the reference's is for its single and pallas
    kinds."""
    if backend != "sharded" or n_devices <= 1 or centers is None:
        return range_partition(edges.n_nodes, n_devices)
    return cluster_partition(centers, n_devices)


def cut_fraction(edges: EdgeList, n_devices: int) -> float:
    """Fraction of edges whose endpoints lie in different contiguous
    ranges."""
    q = ceil_div(edges.n_nodes, n_devices)
    cross = (edges.src // q) != (edges.dst // q)
    return float(cross.mean()) if edges.n_edges else 0.0
