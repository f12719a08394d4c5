"""``repro_torch.analysis``: the static sync/dtype/determinism checks of
the port, the counterpart of the JAX package's ``analysis`` package.

Stdlib only (``python -m repro_torch.analysis src/repro_torch``):

  * :mod:`repro_torch.analysis.sync_lint` — implicit device->host reads
    (``.item()``, ``.cpu()``, ``int()`` of a tensor, a tensor's truth
    value, ...) outside ``guard.fetch``
  * :mod:`repro_torch.analysis.dtype_lint` — distance-dtype bounds, falsy
    integer knobs
  * :mod:`repro_torch.analysis.determinism_lint` — entropy and wall-clock
    reads in the decomposition paths

The runtime half is ``repro_torch.guard``: ``guard.fetch`` is the one
sanctioned read, and ``guard.measured_transfers()`` meters a region and,
on the card, forbids the reads that bypass it.

The reference's fourth checker, ``pallas_lint``, is not ported. It checks
the contracts of ``pl.pallas_call`` (BlockSpec index-map arity, VMEM
scratch size, grid dimension semantics); the port makes no such call. Its
hand-written CUDA kernels are held instead by ``chip_smoke.py``, which
compares every kernel with its plain PyTorch version on the card.

Importing this package imports neither torch nor jax: the checkers parse
the code they check and never import it.
"""
from repro_torch.analysis.common import Finding, SourceFile, run_checkers


def all_checkers():
    """Name -> checker map, importing lazily so that a syntax error in one
    checker does not mask the others in tracebacks."""
    from repro_torch.analysis import determinism_lint, dtype_lint, sync_lint
    return {
        "sync": sync_lint.check,
        "dtype": dtype_lint.check,
        "det": determinism_lint.check,
    }


def run_analysis(paths, checkers=None):
    """Run (a subset of) the checkers. Returns
    ``(active, suppressed, errors)`` finding lists."""
    table = all_checkers()
    if checkers:
        table = {k: v for k, v in table.items() if k in checkers}
    return run_checkers(paths, table)


__all__ = ["Finding", "SourceFile", "run_checkers", "all_checkers",
           "run_analysis"]
