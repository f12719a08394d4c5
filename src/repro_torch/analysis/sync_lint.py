"""sync-lint, the port of the JAX package's: find implicit device->host
reads in the port.

The paper's advantage over Δ-stepping is round complexity; here a round
is a host read, and the pipeline's read counts rest on hand-incremented
counters. This checker keeps the counters and the code from drifting:
every expression that forces a tensor's value onto the host must either

  * go through the sanctioned ``repro_torch.guard.fetch(x, reason=...)``
    (counted at run time, annotated by construction), or
  * carry a ``# sync: <reason>`` pragma on or just above the flagged line.

Detection is an intra-function taint walk, the reference's, with torch's
seeds and sinks. Taint seeds:

  * calls rooted in ``torch`` (or a name bound to a torch module by an
    import, such as ``F`` for ``torch.nn.functional``) that return
    tensors; the calls that return host values (``torch.finfo``,
    ``torch.iinfo``, ``torch.device``, ``torch.cuda.*``, ...) are not
    seeds;
  * parameters annotated ``torch.Tensor`` (or ``Optional[torch.Tensor]``).

Taint propagates through assignment, arithmetic, subscripts, tuple
unpacking and method calls on tainted receivers (``.to(...)``,
``.cuda()``, ``.sum()``, ...); it is CLEARED by metadata (``.shape``,
``.dtype``, ``.device``, ``.ndim``, ``.numel()``, ``.dim()``,
``.size()``, ...) and by ``guard.fetch``, whose result is host numpy.
Sinks:

  SYNC001  int()/float()/complex()/bool() of a tensor (and map(int, ...))
  SYNC002  .item()/.tolist() of a tensor
  SYNC003  .cpu()/.numpy() of a tensor, np.asarray()/np.array() of one
  SYNC004  truthiness of a tensor (if/while/assert/and/or/ternary)
  SYNC005  iteration over a tensor (for / comprehension)
  SYNC006  an explicit synchronisation: torch.cuda.synchronize() or
           .synchronize() on an event or a stream (still a wait on the
           card, so it must be pragma'd to show up in the budget)
"""
from __future__ import annotations

import ast
from typing import List, Optional, Set

from repro_torch.analysis.common import (Finding, SourceFile, dotted_name,
                                         finding)

# attribute access that yields host metadata, not a tensor
_META_ATTRS = {"shape", "dtype", "device", "ndim", "is_cuda", "layout",
               "requires_grad", "is_leaf", "names", "itemsize", "nbytes"}
# method calls that return host metadata
_META_CALLS = {"numel", "dim", "size", "element_size", "data_ptr", "stride",
               "is_contiguous", "get_device", "nelement", "storage_offset",
               "is_floating_point", "is_complex", "is_pinned", "type"}
# methods whose result is a host value: the SYNC002/SYNC003 sinks, and
# .synchronize()
_HOST_RESULT_CALLS = {"item", "tolist", "cpu", "numpy", "synchronize"}
# numpy module aliases whose asarray/array is a device->host sink
_NP_ALIASES = {"np", "numpy", "onp"}
# torch calls that return HOST values (objects, numbers, dtypes): never
# tainted
_HOST_RETURNING = {
    "torch.finfo", "torch.iinfo", "torch.device", "torch.dtype",
    "torch.Size", "torch.get_num_threads", "torch.set_num_threads",
    "torch.get_default_dtype", "torch.is_tensor", "torch.is_grad_enabled",
    "torch.no_grad", "torch.enable_grad", "torch.inference_mode",
    "torch.Generator", "torch.promote_types", "torch.result_type",
    "torch.can_cast", "torch.is_floating_point", "torch.numel",
}
_HOST_RETURNING_PREFIXES = ("torch.cuda.", "torch.backends.",
                            "torch.utils.cpp_extension.", "torch.version.",
                            "torch.library.", "torch.profiler.")


def _root_name(node: ast.AST) -> str:
    while isinstance(node, (ast.Attribute, ast.Subscript, ast.Call)):
        node = getattr(node, "value", None) or getattr(node, "func", None)
        if node is None:
            return ""
    return node.id if isinstance(node, ast.Name) else ""


def _torch_roots(tree: ast.Module) -> Set[str]:
    """``torch`` and every name an import binds to a torch module
    (``import torch.nn.functional as F``, ``from torch import nn``)."""
    roots = {"torch"}
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                if a.name == "torch" or a.name.startswith("torch."):
                    roots.add(a.asname or a.name.split(".")[0])
        elif isinstance(node, ast.ImportFrom) and node.module and (
                node.module == "torch" or node.module.startswith("torch.")):
            for a in node.names:
                # from torch import Tensor: a class, not a tensor-valued
                # module; calling it builds a tensor all the same
                roots.add(a.asname or a.name)
    return roots


def _is_tensor_annotation(node: Optional[ast.AST]) -> bool:
    """``torch.Tensor`` / ``Tensor`` / ``Optional[torch.Tensor]`` (a
    sequence or mapping of tensors is a host container: not a seed)."""
    if node is None:
        return False
    if isinstance(node, ast.Constant) and isinstance(node.value, str):
        try:
            node = ast.parse(node.value, mode="eval").body
        except SyntaxError:
            return False
    name = dotted_name(node)
    if name in ("torch.Tensor", "Tensor"):
        return True
    if isinstance(node, ast.Subscript) and dotted_name(node.value) in (
            "Optional", "typing.Optional"):
        return _is_tensor_annotation(node.slice)
    return False


class _FunctionLinter(ast.NodeVisitor):
    """One function scope: seed taint, propagate, flag sinks."""

    def __init__(self, sf: SourceFile, fn: ast.AST, roots: Set[str],
                 findings: List[Finding]):
        self.sf = sf
        self.fn = fn
        self.roots = roots
        self.findings = findings
        self.record = True   # loop bodies are pre-visited muted
        self.tainted: Set[str] = set()
        args = fn.args
        for a in (args.posonlyargs + args.args + args.kwonlyargs):
            if _is_tensor_annotation(a.annotation):
                self.tainted.add(a.arg)

    # ---- taint query ------------------------------------------------

    def is_tainted(self, node: Optional[ast.AST]) -> bool:
        if node is None:
            return False
        if isinstance(node, ast.Name):
            return node.id in self.tainted
        if isinstance(node, ast.Attribute):
            if node.attr in _META_ATTRS:
                return False
            return self.is_tainted(node.value)
        if isinstance(node, ast.Subscript):
            return self.is_tainted(node.value)
        if isinstance(node, ast.BinOp):
            return self.is_tainted(node.left) or self.is_tainted(node.right)
        if isinstance(node, ast.UnaryOp):
            return self.is_tainted(node.operand)
        if isinstance(node, ast.Compare):
            # `x is None` is an identity check on the python object:
            # host-side, never a read, whatever x holds
            if all(isinstance(op, (ast.Is, ast.IsNot)) for op in node.ops):
                return False
            return (self.is_tainted(node.left)
                    or any(self.is_tainted(c) for c in node.comparators))
        if isinstance(node, ast.IfExp):
            return self.is_tainted(node.body) or self.is_tainted(node.orelse)
        if isinstance(node, (ast.Tuple, ast.List)):
            return any(self.is_tainted(e) for e in node.elts)
        if isinstance(node, ast.Starred):
            return self.is_tainted(node.value)
        if isinstance(node, ast.Call):
            return self._call_tainted(node)
        if isinstance(node, ast.NamedExpr):
            return self.is_tainted(node.value)
        return False

    def _call_tainted(self, node: ast.Call) -> bool:
        name = dotted_name(node.func)
        root = name.split(".", 1)[0] if name else _root_name(node.func)
        # sanctioned fetch: host numpy out, never tainted
        if self._is_guard_fetch(node):
            return False
        if isinstance(node.func, ast.Attribute) and (
                node.func.attr in _META_CALLS
                or node.func.attr in _HOST_RESULT_CALLS):
            # metadata, or a sink whose result is a host value
            return False
        if name in _HOST_RETURNING or \
                name.startswith(_HOST_RETURNING_PREFIXES):
            return False
        # torch.zeros(...), F.softmax(...), torch.stack(...)
        if root in self.roots:
            return True
        # method call on a tainted receiver: x.to(...), x.sum(), ...
        if isinstance(node.func, ast.Attribute):
            return self.is_tainted(node.func.value)
        # builtins that preserve tensor-ness of their argument
        if name in ("abs", "min", "max", "sum"):
            return any(self.is_tainted(a) for a in node.args)
        return False

    @staticmethod
    def _is_guard_fetch(node: ast.Call) -> bool:
        name = dotted_name(node.func)
        return ((name == "fetch" or name.endswith(".fetch"))
                and any(kw.arg == "reason" for kw in node.keywords))

    # ---- helpers ----------------------------------------------------

    def _flag(self, code: str, node: ast.AST, msg: str) -> None:
        if self.record:
            self.findings.append(finding("sync", code, self.sf, node, msg))

    def run(self) -> None:
        """Flow-sensitive single pass. Loop bodies are pre-visited with
        findings muted so loop-carried taint reaches a fixpoint before
        recording; straight-line code keeps statement order, so a host
        value later rebound to a tensor does not poison its earlier
        uses."""
        self.visit(self.fn)

    def _muted_visit(self, *nodes: ast.AST) -> None:
        prev, self.record = self.record, False
        try:
            for n in nodes:
                self.visit(n)
        finally:
            self.record = prev

    def _taint_target(self, target: ast.AST, on: bool) -> None:
        if isinstance(target, ast.Name):
            (self.tainted.add if on else self.tainted.discard)(target.id)
        elif isinstance(target, (ast.Tuple, ast.List)):
            for e in target.elts:
                self._taint_target(e, on)
        elif isinstance(target, ast.Starred):
            self._taint_target(target.value, on)

    def _check_truthiness(self, test: ast.AST) -> None:
        if self.is_tainted(test):
            self._flag("SYNC004", test,
                       "truthiness of a tensor forces a host read (use "
                       "torch.where, or guard.fetch the scalar)")

    # ---- statements -------------------------------------------------

    def visit_Assign(self, node: ast.Assign) -> None:
        self.generic_visit(node)
        on = self.is_tainted(node.value)
        for t in node.targets:
            self._taint_target(t, on)

    def visit_AugAssign(self, node: ast.AugAssign) -> None:
        self.generic_visit(node)
        if self.is_tainted(node.value):
            self._taint_target(node.target, True)

    def visit_AnnAssign(self, node: ast.AnnAssign) -> None:
        self.generic_visit(node)
        if node.value is not None and node.target is not None:
            self._taint_target(node.target, self.is_tainted(node.value))

    def visit_If(self, node: ast.If) -> None:
        self._check_truthiness(node.test)
        self.generic_visit(node)

    def visit_While(self, node: ast.While) -> None:
        for stmt in node.body:
            self._muted_visit(stmt)
        self._check_truthiness(node.test)
        self.generic_visit(node)

    def visit_Assert(self, node: ast.Assert) -> None:
        self._check_truthiness(node.test)
        self.generic_visit(node)

    def visit_IfExp(self, node: ast.IfExp) -> None:
        self._check_truthiness(node.test)
        self.generic_visit(node)

    def visit_BoolOp(self, node: ast.BoolOp) -> None:
        for v in node.values:
            if self.is_tainted(v):
                self._flag("SYNC004", v,
                           "and/or on a tensor coerces it to bool (a host "
                           "read); use & / |")
        self.generic_visit(node)

    def _iterate(self, target: ast.AST, it: ast.AST, msg: str) -> None:
        """A loop or comprehension: ``it`` is flagged when it is a tensor.
        A tuple or list display (``for t in (q, k, v)``) is a host
        container of its elements, not a tensor: nothing is flagged, and
        the target takes its elements' taint, position by position when
        the elements are displays of the target's arity."""
        if not isinstance(it, (ast.Tuple, ast.List)):
            if self.is_tainted(it):
                self._flag("SYNC005", it, msg)
            self._taint_target(target, self.is_tainted(it))
            return
        rows = it.elts
        if isinstance(target, (ast.Tuple, ast.List)) and rows and all(
                isinstance(r, (ast.Tuple, ast.List))
                and len(r.elts) == len(target.elts) for r in rows):
            for j, t in enumerate(target.elts):
                self._taint_target(t, any(self.is_tainted(r.elts[j])
                                          for r in rows))
        else:
            self._taint_target(target, any(self.is_tainted(e) for e in rows))

    def visit_For(self, node: ast.For) -> None:
        prev, self.record = self.record, False
        try:   # the target's taint first, for the muted pass over the body
            self._iterate(node.target, node.iter, "")
        finally:
            self.record = prev
        for stmt in node.body:
            self._muted_visit(stmt)
        self._iterate(node.target, node.iter,
                      "iterating a tensor indexes it once per element (and "
                      "a per-element read usually follows); batch into one "
                      "guard.fetch")
        self.generic_visit(node)

    def visit_comprehension(self, node: ast.comprehension) -> None:
        self._iterate(node.target, node.iter,
                      "a comprehension over a tensor indexes it element-wise "
                      "(and a per-element read usually follows); batch into "
                      "one guard.fetch")
        self.generic_visit(node)

    # ---- calls (the scalar-coercion sinks) --------------------------

    def visit_Call(self, node: ast.Call) -> None:
        name = dotted_name(node.func)
        arg0 = node.args[0] if node.args else None
        attr = node.func.attr if isinstance(node.func, ast.Attribute) else ""
        if name in ("int", "float", "complex", "bool") \
                and self.is_tainted(arg0):
            self._flag("SYNC001", node,
                       f"{name}() of a tensor is an implicit device->host "
                       "read; route it through guard.fetch")
        elif attr in ("item", "tolist") and self.is_tainted(node.func.value):
            self._flag("SYNC002", node,
                       f".{attr}() of a tensor is an implicit device->host "
                       "read; route it through guard.fetch")
        elif attr in ("cpu", "numpy") and self.is_tainted(node.func.value):
            self._flag("SYNC003", node,
                       f".{attr}() of a tensor copies it to the host; route "
                       "it through guard.fetch so the read is counted")
        elif (name.split(".", 1)[0] in _NP_ALIASES
              and name.split(".")[-1] in ("asarray", "array")
              and self.is_tainted(arg0)):
            self._flag("SYNC003", node,
                       "np.asarray() of a tensor copies it to the host; "
                       "route it through guard.fetch so the read is "
                       "counted")
        elif name == "torch.cuda.synchronize" or attr == "synchronize":
            self._flag("SYNC006", node,
                       "explicit synchronisation; annotate it with "
                       "'# sync:' so it shows up in the read budget")
        elif name == "map" and len(node.args) == 2:
            # map(int, <tensor>): coerces element-wise on the host
            f, it = node.args
            if (isinstance(f, ast.Name) and f.id in ("int", "float")
                    and self.is_tainted(it)):
                self._flag("SYNC001", node,
                           "map(int, <tensor>) reads element-wise on the "
                           "host; guard.fetch the vector first")
        self.generic_visit(node)

    # nested defs get their own scope (a fresh linter)
    def visit_FunctionDef(self, node: ast.FunctionDef) -> None:
        if node is self.fn:
            self.generic_visit(node)
        elif self.record:   # nested scopes linted once, on the record pass
            _FunctionLinter(self.sf, node, self.roots, self.findings).run()

    visit_AsyncFunctionDef = visit_FunctionDef

    def visit_Lambda(self, node: ast.Lambda) -> None:
        # lambdas inherit the enclosing taint set (closures)
        self.generic_visit(node)


def check(sf: SourceFile) -> List[Finding]:
    findings: List[Finding] = []
    roots = _torch_roots(sf.tree)
    for node in sf.tree.body:
        _lint_scope(sf, node, roots, findings)
    return findings


def _lint_scope(sf: SourceFile, node: ast.AST, roots: Set[str],
                findings: List[Finding]) -> None:
    if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
        _FunctionLinter(sf, node, roots, findings).run()
    elif isinstance(node, ast.ClassDef):
        for item in node.body:
            _lint_scope(sf, item, roots, findings)
    # module-level statements: no taint seeds (imports, constants)
