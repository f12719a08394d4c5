"""dtype-bound-lint, the port of the JAX package's: distance arithmetic
must go through the provable bound helpers, and integer knobs must never
be truthiness-coerced.

Two bug classes the reference shipped and fixed by hand:

  DTYPE001  bare int32 distance accumulation (an int32 overflow): a
            function that (a) builds an int32 array (``torch.int32``,
            ``np.int32``, ``jnp.int32``: a cast, a ``dtype=`` value or a
            ``.to``/``.astype`` argument), (b) adds a distance-named term
            to a weight-named term, and (c) never consults
            ``sssp_dtype_for`` (``core/sssp.py``, the provable-bound dtype
            picker) can silently wrap ``d + w`` past 2^31 on heavy graphs.
            Routing through ``sssp_dtype_for(n, max_weight, delta)``
            clears the finding.

  DTYPE002  falsy coercion of an integer knob (the ``--tau 0`` bug):
            ``tau or DEFAULT``, ``not tau``, ``if tau:`` treat the legal
            value 0 as "unset". Knobs must compare ``is None`` /
            ``== 0`` explicitly. Checked for the knob names
            {tau, tau_solve, delta, levels} as bare names or attribute
            tails (``args.tau``, ``cfg.levels``).
"""
from __future__ import annotations

import ast
import re
from typing import List

from repro_torch.analysis.common import (Finding, SourceFile, dotted_name,
                                         finding)

_KNOBS = {"tau", "tau_solve", "delta", "levels"}
_DIST_RE = re.compile(r"^(d|d0|dist|distance|pathw|fp|path_w)\d*(_\w+)?$")
_WEIGHT_RE = re.compile(r"^(w|wt|weight|weights|qw|wd)\d*(_\w+)?$")


def _name_tail(node: ast.AST) -> str:
    if isinstance(node, ast.Name):
        return node.id
    if isinstance(node, ast.Attribute):
        return node.attr
    return ""


def _matches(node: ast.AST, pattern: re.Pattern) -> bool:
    if isinstance(node, ast.Name):
        return bool(pattern.match(node.id))
    if isinstance(node, ast.Subscript):     # d[src] + w
        return _matches(node.value, pattern)
    if isinstance(node, ast.Call):          # d.astype(...) + w
        if isinstance(node.func, ast.Attribute):
            return _matches(node.func.value, pattern)
    return False


def _is_int32_marker(node: ast.AST) -> bool:
    """torch.int32 / np.int32 / jnp.int32 reference (as a cast, dtype=
    value, or .to / .astype argument)."""
    name = dotted_name(node)
    return name.endswith(".int32") or name == "int32"


class _FnScan(ast.NodeVisitor):
    def __init__(self):
        self.makes_int32 = False
        self.dist_plus_weight: List[ast.BinOp] = []
        self.calls_dtype_helper = False

    def visit_Call(self, node: ast.Call) -> None:
        name = dotted_name(node.func)
        if name.endswith("sssp_dtype_for") or name.endswith("dtype_for"):
            self.calls_dtype_helper = True
        if _is_int32_marker(node.func):
            self.makes_int32 = True
        for a in list(node.args) + [kw.value for kw in node.keywords]:
            if _is_int32_marker(a):
                self.makes_int32 = True
        self.generic_visit(node)

    def visit_keyword(self, node: ast.keyword) -> None:
        if node.arg == "dtype" and _is_int32_marker(node.value):
            self.makes_int32 = True
        self.generic_visit(node)

    def visit_BinOp(self, node: ast.BinOp) -> None:
        if isinstance(node.op, ast.Add):
            pair = (node.left, node.right)
            for a, b in (pair, pair[::-1]):
                if _matches(a, _DIST_RE) and _matches(b, _WEIGHT_RE):
                    self.dist_plus_weight.append(node)
                    break
        self.generic_visit(node)


def check(sf: SourceFile) -> List[Finding]:
    findings: List[Finding] = []
    for node in ast.walk(sf.tree):
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            scan = _FnScan()
            scan.visit(node)
            if (scan.makes_int32 and scan.dist_plus_weight
                    and not scan.calls_dtype_helper):
                for binop in scan.dist_plus_weight:
                    findings.append(finding(
                        "dtype", "DTYPE001", sf, binop,
                        "int32 distance accumulation without "
                        "sssp_dtype_for: d + w can wrap past 2^31; pick "
                        "the dtype from the provable bound"))
        elif isinstance(node, ast.BoolOp) and isinstance(node.op, ast.Or):
            head = node.values[0]
            if _name_tail(head) in _KNOBS:
                findings.append(finding(
                    "dtype", "DTYPE002", sf, node,
                    f"'{_name_tail(head)} or ...' coerces the legal value "
                    "0 to the fallback (the --tau 0 bug); compare "
                    "'is None' explicitly"))
        elif isinstance(node, ast.UnaryOp) and isinstance(node.op, ast.Not):
            if _name_tail(node.operand) in _KNOBS:
                findings.append(finding(
                    "dtype", "DTYPE002", sf, node,
                    f"'not {_name_tail(node.operand)}' is true for the "
                    "legal value 0; compare 'is None' explicitly"))
        elif isinstance(node, (ast.If, ast.While)):
            if _name_tail(node.test) in _KNOBS:
                findings.append(finding(
                    "dtype", "DTYPE002", sf, node.test,
                    f"truthiness of knob '{_name_tail(node.test)}' treats "
                    "0 as unset; compare 'is None' explicitly"))
    return findings
