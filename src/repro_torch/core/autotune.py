"""Graph-statistics autotuner for the decomposition pipeline's knobs, the
port of the JAX package's ``core/autotune.py``, priced for the H100.

One cheap device pass over the edges gives the statistics (in-degree and
edge-weight log2 histograms of 32 buckets each, the largest in-degree, the
smallest and largest weight) in one packed host read; ``derive_tuning``
turns them into a ``TuningRecord``; records are cached in-process by a
graph signature, and ``record`` mode persists the cache to JSON.

What stays the reference's, and what is the card's:

  * ``tau``, ``tau_solve``, ``levels``, ``delta_init`` and ``signature``
    depend on the graph only and are computed as the reference computes
    them, value for value;
  * ``predicted_superstep_s`` is ``runtime/roofline.relax_pass_bytes``
    over the card's HBM rate (the CUDA kernels derive their lanes and
    long-row split from the CSR, so there is no tiling to choose, and the
    reference's ``node_tile``/``edge_block``/``padded_edges`` have no
    counterpart);
  * ``fuse`` is ``DEFAULT_K_FUSED`` for the kernel backend on a CUDA device
    when the megakernel's int32 counts allow it (``n * (K + 1) < 2^31``,
    the one precondition ``KernelBackend`` checks; the cooperative grid is
    sized from occupancy when it launches), else 0;
  * ``mode`` follows the reference's formula with ``_HOST_SYNC_S``
    measured on the card.

Pin semantics (see ``GraphSession``): an explicit ``tau``/``tau_solve``, a
numeric ``delta_init``, an explicit ``stages``/``oneshot`` mode, a nonzero
``fuse_supersteps`` and a prebuilt backend always win over the record.
"""
from __future__ import annotations

import dataclasses
import hashlib
import json
import math
import os
from dataclasses import dataclass
from typing import Dict, Optional, Tuple, Union

import numpy as np
import torch

from repro_torch import guard
from repro_torch.common import get_logger, resolve_device, to_device
from repro_torch.graph.structures import EdgeList
from repro_torch.kernels.edge_relax.megakernel import DEFAULT_K_FUSED
from repro_torch.runtime.roofline import HBM_BYTES_PER_S, relax_pass_bytes

log = get_logger("repro_torch.autotune")

N_BUCKETS = 32  # log2 histogram buckets (covers the int32 range)

# The reference buckets x as floor(log2(float32(max(x, 1)))) with its CPU
# float32 log2 (log(x) / log(2), not exact at every power of two: 8,192
# lands in bucket 12 and 2^21 - 1 in bucket 21). The bucket is monotone in
# x, so it is the number of these thresholds at or below x: the least x of
# buckets 1..30, read off that path (tests/test_torch_autotune.py holds the
# table against it at every integer within 2^(k-10) of each 2^k). Counting
# thresholds gives the same bucket on every device.
BUCKET_THRESHOLDS = (
    2, 4, 8, 16, 32, 64, 128, 256, 512, 1024, 2048, 4096, 8193, 16384,
    32769, 65536, 131072, 262144, 524288, 1048576, 2097151, 4194303,
    8388601, 16777201, 33554418, 67108869, 134217801, 268435209, 536870673,
    1073741889)

# cluster-count model k_hat ~ C * tau * log n (the reference's calibration;
# it only picks the cascade depth)
_CLUSTERS_PER_TAU_LOG_N = 2.2

# a source skew (max_degree / avg_degree) beyond this marks a hub-heavy
# graph: tau doubles
_HUB_SKEW = 32.0

# host seconds of one stage-loop read: guard.fetch of one int32 after a
# launch, the median of 200 on an NVIDIA H100 80GB HBM3 at a 700.00 W power
# limit (chip_smoke.py phase host_read; p10 3.61e-5, p90 4.16e-5). The
# stage engine pays one per stage, the one-shot engine its fixpoint's extra
# supersteps, so the mode choice compares the two.
_HOST_SYNC_S = 3.7316e-5

TUNE_EVENTS: Dict[str, int] = {"hits": 0, "misses": 0}


class AutotuneError(ValueError):
    """A derived tuning record failed validation."""


@dataclass(frozen=True)
class GraphStats:
    """One-pass device statistics of an edge list."""

    n_nodes: int
    n_edges: int
    avg_degree: float
    max_degree: int
    min_weight: int
    avg_weight: int
    max_weight: int
    weight_sum: int
    degree_hist: Tuple[int, ...]  # log2-bucketed in-degree counts
    weight_hist: Tuple[int, ...]  # log2-bucketed edge-weight counts


@dataclass(frozen=True)
class TuningRecord:
    """Derived pipeline knobs and the model prediction behind the mode."""

    signature: str
    tau: int
    tau_solve: int
    levels: int               # cascade depth (0 = direct quotient solve)
    delta_init: int
    fuse: int                 # megakernel fusion depth (0 = unfused)
    predicted_superstep_s: float  # byte bound of one relax pass
    mode: str = "stages"      # the decomposition mode for cfg.mode="auto"


def _hist(x: torch.Tensor, bounds: torch.Tensor) -> torch.Tensor:
    """Bucket counts of ``x`` (int64 [N_BUCKETS]): sort, then count the
    values below each threshold; no atomics and no host read."""
    s = torch.sort(x.clamp_min(1)).values
    below = torch.searchsorted(s, bounds)            # #(x < T_k), k = 1..30
    # #(x < T_k) for k = 0..32, where no value is below T_0 and every value
    # is below T_31 and T_32
    cum = torch.cat([below.new_zeros(1), below,
                     below.new_full((N_BUCKETS - bounds.numel(),),
                                    x.numel())])
    return cum[1:] - cum[:-1]


def _stats_pass(dst: torch.Tensor, weight: torch.Tensor,
                n_nodes: int) -> torch.Tensor:
    """Everything histogram-shaped, packed as int64
    ``[deg_hist(32) | weight_hist(32) | max_deg, min_w, max_w]``."""
    deg = torch.zeros(n_nodes, dtype=torch.int64, device=dst.device)
    deg.index_add_(0, dst.to(torch.int64),
                   torch.ones_like(dst, dtype=torch.int64))
    w = weight.to(torch.int64)
    bounds = to_device(np.asarray(BUCKET_THRESHOLDS), dst.device,
                       torch.int64)
    scalars = torch.stack([deg.max(), w.min(), w.max()])
    return torch.cat([_hist(deg, bounds), _hist(w, bounds), scalars])


def compute_graph_stats(edges: EdgeList,
                        device: Union[str, torch.device] = "cuda"
                        ) -> GraphStats:
    """Device histograms and ONE packed host read. The weight sum (which
    can overflow int32) is reduced on the host from the numpy edges."""
    n, e = edges.n_nodes, edges.n_edges
    if n == 0 or e == 0:
        zeros = (0,) * N_BUCKETS
        return GraphStats(n, e, 0.0, 0, 1, 1, 1, 0, zeros, zeros)
    dev = resolve_device(device)
    vec = guard.fetch(
        _stats_pass(to_device(edges.dst, dev), to_device(edges.weight, dev),
                    n),
        reason="autotune: packed degree/weight histograms")
    deg_hist = tuple(int(x) for x in vec[:N_BUCKETS])
    w_hist = tuple(int(x) for x in vec[N_BUCKETS:2 * N_BUCKETS])
    max_deg, min_w, max_w = (int(x) for x in vec[2 * N_BUCKETS:])
    w_sum = int(edges.weight.astype(np.int64).sum())
    return GraphStats(
        n_nodes=n, n_edges=e, avg_degree=e / n, max_degree=max_deg,
        min_weight=min_w, avg_weight=max(w_sum // e, 1), max_weight=max_w,
        weight_sum=w_sum, degree_hist=deg_hist, weight_hist=w_hist)


def graph_signature(stats: GraphStats) -> str:
    """Stable content key: graphs with identical coarse statistics share a
    tuning record (the reference's payload and hash)."""
    payload = (stats.n_nodes, stats.n_edges, stats.max_degree,
               stats.min_weight, stats.max_weight, stats.weight_sum,
               stats.degree_hist, stats.weight_hist)
    return hashlib.md5(repr(payload).encode()).hexdigest()[:16]


# ---------------------------------------------------------------------------
# knob derivation
# ---------------------------------------------------------------------------


def _median_weight_bucket(stats: GraphStats) -> int:
    half = max(stats.n_edges, 1) / 2
    acc = 0
    for b, cnt in enumerate(stats.weight_hist):
        acc += cnt
        if acc >= half:
            return b
    return 0


def _fuse_fits(n_nodes: int, fuse: int) -> bool:
    """The megakernel's int32 counts: ``n * (fuse + 1) < 2^31``."""
    return n_nodes * (fuse + 1) < 2**31


def derive_tuning(stats: GraphStats, *, backend: str = "kernel",
                  device: Union[str, torch.device] = "cuda",
                  tau_fraction: float = 1e-3) -> TuningRecord:
    """Map graph statistics to pipeline knobs. Every choice is a
    PERFORMANCE decision: the pipeline is correct for any legal value."""
    n = max(stats.n_nodes, 1)
    logn = max(math.log(max(n, 2)), 1.0)

    # tau: the session default (n * fraction / log n), doubled on hub-heavy
    # graphs, where a larger quotient is the cheaper way to shrink the
    # radius term of Phi_approx
    tau = max(int(n * tau_fraction / logn), 4)
    skew = stats.max_degree / max(stats.avg_degree, 1.0)
    if skew > _HUB_SKEW:
        tau = min(tau * 2, max(n // 8, 4))
    tau = max(4, min(tau, n))

    # cascade depth from the expected cluster count
    k_hat = min(n, max(1, int(_CLUSTERS_PER_TAU_LOG_N * tau * logn)))
    tau_solve = max(64, min(1024, int(math.sqrt(n))))
    if k_hat <= tau_solve:
        levels = 0
    else:
        levels = min(2, math.ceil(math.log(k_hat / tau_solve) / math.log(3)))

    # delta_init: one bucket above the median edge weight
    b = _median_weight_bucket(stats)
    delta_init = max(1, min(2 ** (b + 1), 2**30 - 1))

    pred_t = relax_pass_bytes(stats.n_nodes, stats.n_edges) / HBM_BYTES_PER_S
    fuse = 0
    if (backend == "kernel" and torch.device(device).type == "cuda"
            and _fuse_fits(stats.n_nodes, DEFAULT_K_FUSED)):
        fuse = DEFAULT_K_FUSED

    # the stage loop needs ~ log2(n / threshold) stages, each a host read;
    # one-shot pays one read but sweeps the hop radius (~ sqrt(n) on road
    # graphs) in one grow call: pick whichever the model prices cheaper
    s_hat = max(1, math.ceil(math.log2(max(n / max(8.0 * tau * logn, 1.0),
                                           2.0))))
    hop_hat = max(int(math.sqrt(n)), 1)
    mode = ("oneshot" if s_hat * _HOST_SYNC_S > hop_hat * pred_t
            else "stages")

    return TuningRecord(
        signature=graph_signature(stats), tau=tau, tau_solve=tau_solve,
        levels=levels, delta_init=delta_init, fuse=fuse,
        predicted_superstep_s=pred_t, mode=mode)


def validate_tuning(rec: TuningRecord, stats: GraphStats) -> None:
    """Range checks of a record (guards hand-edited or stale cache
    entries)."""
    if not 1 <= rec.tau <= max(stats.n_nodes, 4):
        raise AutotuneError(f"tau {rec.tau} out of range for n={stats.n_nodes}")
    if rec.tau_solve < 2:
        raise AutotuneError(f"tau_solve must be >= 2, got {rec.tau_solve}")
    if not 0 <= rec.levels <= 4:
        raise AutotuneError(f"levels must be in [0, 4], got {rec.levels}")
    if not 1 <= rec.delta_init < 2**30:
        raise AutotuneError(f"delta_init {rec.delta_init} outside [1, 2^30)")
    if rec.fuse < 0:
        raise AutotuneError(f"fuse must be >= 0, got {rec.fuse}")
    if rec.fuse and not _fuse_fits(stats.n_nodes, rec.fuse):
        raise AutotuneError(
            f"fuse {rec.fuse} at n={stats.n_nodes}: the megakernel's int32 "
            "counts need n * (fuse + 1) < 2^31")
    if rec.mode not in ("stages", "oneshot"):
        raise AutotuneError(
            f"mode must be 'stages' or 'oneshot' (a record stores the "
            f"RESOLVED mode, never 'auto'), got {rec.mode!r}")


# ---------------------------------------------------------------------------
# cache
# ---------------------------------------------------------------------------

_CACHE: Dict[str, TuningRecord] = {}


def _default_cache_path() -> str:
    return os.environ.get(
        "REPRO_TORCH_AUTOTUNE_CACHE",
        os.path.join(os.path.expanduser("~"), ".cache",
                     "repro_torch_autotune.json"))


def _cache_key(sig: str, backend: str, device: torch.device) -> str:
    return f"{sig}:{backend}:{device.type}"


def clear_cache() -> None:
    _CACHE.clear()
    TUNE_EVENTS["hits"] = TUNE_EVENTS["misses"] = 0


def save_cache(path: Optional[str] = None) -> str:
    path = path or _default_cache_path()
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    payload = {k: dataclasses.asdict(v) for k, v in _CACHE.items()}
    with open(path, "w") as f:
        json.dump(payload, f, indent=1, sort_keys=True)
    return path


def load_cache(path: Optional[str] = None) -> int:
    """Populate the in-process cache from a recorded JSON file; returns the
    number of records loaded (0 when the file is absent)."""
    path = path or _default_cache_path()
    if not os.path.exists(path):
        return 0
    with open(path) as f:
        payload = json.load(f)
    for k, d in payload.items():
        _CACHE[k] = TuningRecord(**d)
    return len(payload)


def get_tuning(edges: EdgeList, *, backend: str = "kernel",
               device: Union[str, torch.device] = "cuda",
               record: bool = False,
               cache_path: Optional[str] = None) -> TuningRecord:
    """Stats pass + derivation with in-process caching. ``record=True``
    also persists the cache file after a miss."""
    dev = resolve_device(device)
    stats = compute_graph_stats(edges, dev)
    key = _cache_key(graph_signature(stats), backend, dev)
    hit = _CACHE.get(key)
    if hit is not None:
        TUNE_EVENTS["hits"] += 1
        return hit
    TUNE_EVENTS["misses"] += 1
    rec = derive_tuning(stats, backend=backend, device=dev)
    validate_tuning(rec, stats)
    _CACHE[key] = rec
    if record:
        save_cache(cache_path)
    log.info("autotuned %s: tau=%d tau_solve=%d levels=%d delta0=%d fuse=%d "
             "mode=%s", key, rec.tau, rec.tau_solve, rec.levels,
             rec.delta_init, rec.fuse, rec.mode)
    return rec
