"""determinism-lint, the port of the JAX package's: decomposition paths
promise byte-identical output.

The port's decompositions are byte-identical to the reference's for the
same seed (``core/prng.py`` reproduces its ``jax.random`` draws), the
kernels are held to their plain versions bit for bit, and the dynamic
path's certified re-clustering depends on replayable decisions. These
only hold if nothing in the decomposition modules draws entropy from
outside the seeded draws:

  DET001  unseeded randomness: np.random.* module-state calls, random.*,
          ``default_rng()`` / ``SeedSequence()`` without a seed, and
          torch's global generator (``torch.manual_seed``, ``torch.rand*``
          / ``randperm`` / ``normal`` / ``bernoulli`` / ``multinomial``
          and the in-place samplers ``.uniform_()``, ``.normal_()``, ...
          without a ``generator=``). A seeded ``default_rng(seed)``,
          ``SeedSequence(seed)`` or an explicit ``torch.Generator`` is
          fine.
  DET002  time-dependent values (time.time/monotonic/perf_counter,
          datetime.now). Inside decomposition modules wall-clock must
          never reach a decision; in every other ``repro_torch`` module
          bare clock reads must route through the one sanctioned seam,
          ``repro_torch.runtime.telemetry.clock()``/``wall_time()`` (the
          DET002 twin of ``guard.fetch``), so timing sites stay
          auditable. ``runtime/telemetry`` itself is the exempt seam.
  DET003  iteration-order dependence on sets: materializing a set into
          an ordered container (list/tuple/sorted-less np.fromiter/
          np.array, or a bare for-loop) makes downstream output depend
          on hash-iteration order. Tracked for intra-function set
          values and the known set-typed attributes of the dynamic
          subsystem (``dirty_centers``).
  DET004  builtin hash() — PYTHONHASHSEED-dependent for strings.

Rules DET003–DET004 apply only inside decomposition modules (engine,
state, dynamic, quotient, cluster, prng, kernels); DET002 applies to
every ``repro_torch`` module except the telemetry seam; DET001 applies
everywhere.
"""
from __future__ import annotations

import ast
from typing import List, Set

from repro_torch.analysis.common import (Finding, SourceFile, dotted_name,
                                         finding)

_DECOMP_MARKERS = ("core/engine", "core/state", "core/dynamic",
                   "core/quotient", "core/cluster", "core/prng", "kernels/")

# the ONE module allowed to read the clock directly — everything else in
# repro_torch/ must call telemetry.clock()/wall_time()
_CLOCK_SEAM_MARKERS = ("runtime/telemetry",)

# attributes known (module contract) to hold builtin sets
_KNOWN_SET_ATTRS = {"dirty_centers"}

_TIME_CALLS = {"time.time", "time.monotonic", "time.perf_counter",
               "time.process_time", "datetime.now", "datetime.utcnow",
               "datetime.datetime.now", "datetime.datetime.utcnow"}

# torch's global-generator draws: flagged unless a generator= is passed
_TORCH_DRAWS = {"torch.rand", "torch.randn", "torch.randint", "torch.randperm",
                "torch.rand_like", "torch.randn_like", "torch.randint_like",
                "torch.normal", "torch.bernoulli", "torch.multinomial",
                "torch.poisson"}
_TORCH_SEEDS = {"torch.manual_seed", "torch.seed", "torch.cuda.manual_seed",
                "torch.cuda.manual_seed_all", "torch.cuda.seed",
                "torch.cuda.seed_all", "torch.random.manual_seed",
                "torch.random.seed"}
_INPLACE_DRAWS = {"uniform_", "normal_", "random_", "exponential_",
                  "bernoulli_", "geometric_", "log_normal_", "cauchy_"}

_ORDERING_CONSUMERS = {"list", "tuple", "np.fromiter", "numpy.fromiter",
                       "np.array", "numpy.array", "np.asarray",
                       "numpy.asarray"}


def _is_decomp_module(path: str) -> bool:
    p = path.replace("\\", "/")
    return any(m in p for m in _DECOMP_MARKERS)


def _clock_scope(path: str) -> bool:
    """DET002 applies to every repro_torch module except the sanctioned
    telemetry seam (and to all decomposition modules regardless)."""
    p = path.replace("\\", "/")
    if any(m in p for m in _CLOCK_SEAM_MARKERS):
        return False
    return "repro_torch/" in p or _is_decomp_module(path)


def _is_set_expr(node: ast.AST, set_names: Set[str]) -> bool:
    if isinstance(node, ast.Set) or isinstance(node, ast.SetComp):
        return True
    if isinstance(node, ast.Call) and dotted_name(node.func) == "set":
        return True
    if isinstance(node, ast.Name):
        return node.id in set_names
    if isinstance(node, ast.Attribute):
        return node.attr in _KNOWN_SET_ATTRS
    if isinstance(node, ast.BinOp) and isinstance(node.op, ast.BitOr):
        return (_is_set_expr(node.left, set_names)
                or _is_set_expr(node.right, set_names))
    return False


class _Scope(ast.NodeVisitor):
    def __init__(self, sf: SourceFile, findings: List[Finding],
                 decomp: bool, clocked: bool):
        self.sf = sf
        self.findings = findings
        self.decomp = decomp
        self.clocked = clocked
        self.set_names: Set[str] = set()

    def _flag(self, code: str, node: ast.AST, msg: str) -> None:
        self.findings.append(finding("det", code, self.sf, node, msg))

    def visit_Assign(self, node: ast.Assign) -> None:
        self.generic_visit(node)
        if _is_set_expr(node.value, self.set_names):
            for t in node.targets:
                if isinstance(t, ast.Name):
                    self.set_names.add(t.id)

    def visit_Call(self, node: ast.Call) -> None:
        name = dotted_name(node.func)
        # DET001 — global-state randomness (everywhere)
        if name.startswith(("np.random.", "numpy.random.", "random.")):
            tail = name.split(".")[-1]
            if tail not in ("default_rng", "Generator", "SeedSequence",
                            "PCG64"):
                self._flag("DET001", node,
                           f"{name}() draws from global RNG state; use "
                           "np.random.default_rng(seed) so decompositions "
                           "replay byte-identically")
            elif tail in ("default_rng", "SeedSequence") and not node.args \
                    and not node.keywords:
                self._flag("DET001", node,
                           f"{tail}() without a seed is entropy-"
                           "seeded; pass an explicit seed")
        if name in _TORCH_SEEDS:
            self._flag("DET001", node,
                       f"{name}() sets torch's global generator; draw from "
                       "an explicit torch.Generator instead")
        elif (name in _TORCH_DRAWS
              or (isinstance(node.func, ast.Attribute)
                  and node.func.attr in _INPLACE_DRAWS)) \
                and not any(kw.arg == "generator" for kw in node.keywords):
            self._flag("DET001", node,
                       f"{name or node.func.attr}() draws from torch's "
                       "global generator; pass generator= so the draw "
                       "replays")
        # DET002 — bare wall clock outside the sanctioned seam
        if self.clocked and name in _TIME_CALLS:
            if self.decomp:
                self._flag("DET002", node,
                           f"{name}() inside a decomposition module: "
                           "wall-clock must never reach a decision")
            else:
                self._flag("DET002", node,
                           f"{name}() bypasses the sanctioned clock seam; "
                           "route timing through repro_torch.runtime."
                           "telemetry.clock()/wall_time()")
        if self.decomp:
            # DET003 — ordered materialization of a set
            if name in _ORDERING_CONSUMERS and node.args and \
                    _is_set_expr(node.args[0], self.set_names):
                self._flag("DET003", node,
                           f"{name}(<set>) fixes hash-iteration order "
                           "into the output; sort first or prove the "
                           "consumer order-insensitive")
            # DET004 — builtin hash
            if name == "hash":
                self._flag("DET004", node,
                           "builtin hash() is PYTHONHASHSEED-dependent "
                           "for strings; use a keyed/integer hash")
        self.generic_visit(node)

    def visit_For(self, node: ast.For) -> None:
        if self.decomp and _is_set_expr(node.iter, self.set_names):
            self._flag("DET003", node.iter,
                       "iterating a set fixes hash order into control "
                       "flow; sort first or prove order-insensitivity")
        self.generic_visit(node)

    def visit_comprehension(self, node: ast.comprehension) -> None:
        if self.decomp and _is_set_expr(node.iter, self.set_names):
            self._flag("DET003", node.iter,
                       "comprehension over a set fixes hash order into "
                       "the result; sort first")
        self.generic_visit(node)


def check(sf: SourceFile) -> List[Finding]:
    findings: List[Finding] = []
    _Scope(sf, findings, _is_decomp_module(sf.path),
           _clock_scope(sf.path)).visit(sf.tree)
    return findings
