"""Shared infrastructure for the ``repro_torch.analysis`` checkers, the
port of the JAX package's ``analysis/common.py``.

Everything here is stdlib-only (``ast`` + ``re``): the static half of the
suite must run in a bare CI job with neither torch nor jax installed, and
must never import the code it is checking.

The unit of work is a :class:`SourceFile` — parsed AST plus the per-line
pragma table. A checker is a function ``(SourceFile) -> list[Finding]``;
suppression is applied centrally in :func:`run_checkers` so every checker
shares one pragma grammar:

    # sync: <reason>      suppress sync-lint on this line / the next line
    # dtype: <reason>     suppress dtype-bound-lint
    # det: <reason>       suppress determinism-lint

A pragma with an empty reason is itself a finding (PRAGMA000): the whole
point is that every intentional violation carries a justification the
reviewer can audit.
"""
from __future__ import annotations

import ast
import re
from dataclasses import dataclass, field
from pathlib import Path
from typing import Callable, Dict, Iterable, List, Optional, Sequence, Set

CHECKERS = ("sync", "dtype", "det")

# "# sync: reason" (reason mandatory) — also match a bare "# sync:" so we
# can flag the missing justification instead of silently ignoring it
_PRAGMA_RE = re.compile(
    r"#\s*(?P<checker>sync|dtype|det)\s*:(?P<reason>.*)$")


@dataclass(frozen=True)
class Finding:
    """One checker hit, anchored to a source line (``end_line`` tracks
    multi-line statements so a pragma beside the closing paren still
    suppresses)."""

    checker: str   # one of CHECKERS (or "pragma" for grammar errors)
    code: str      # short rule id, e.g. "SYNC001"
    path: str
    line: int
    message: str
    end_line: int = 0

    def format(self) -> str:
        return (f"{self.path}:{self.line}: "
                f"[{self.checker}/{self.code}] {self.message}")


@dataclass
class Pragma:
    checker: str
    reason: str
    line: int


@dataclass
class SourceFile:
    """A parsed module plus its pragma table."""

    path: str
    text: str
    tree: ast.Module
    lines: List[str] = field(default_factory=list)
    # checker -> set of line numbers the pragma covers (its own line and
    # the next, so a standalone pragma comment covers the statement below)
    pragma_lines: Dict[str, Set[int]] = field(default_factory=dict)
    pragmas: List[Pragma] = field(default_factory=list)
    empty_pragmas: List[Pragma] = field(default_factory=list)

    @classmethod
    def parse(cls, path: str, text: Optional[str] = None) -> "SourceFile":
        if text is None:
            text = Path(path).read_text()
        tree = ast.parse(text, filename=path)
        sf = cls(path=path, text=text, tree=tree,
                 lines=text.splitlines(),
                 pragma_lines={c: set() for c in CHECKERS})
        for lineno, line in enumerate(sf.lines, start=1):
            m = _PRAGMA_RE.search(line)
            if not m:
                continue
            p = Pragma(checker=m.group("checker"),
                       reason=m.group("reason").strip(), line=lineno)
            if not p.reason:
                sf.empty_pragmas.append(p)
                continue
            sf.pragmas.append(p)
            sf.pragma_lines[p.checker].update((lineno, lineno + 1))
        return sf

    def is_suppressed(self, checker: str, node: ast.AST) -> bool:
        """A finding is suppressed when any line the flagged statement
        spans (or the line just above it) carries that checker's pragma —
        multi-line calls keep their pragma next to the closing paren."""
        covered = self.pragma_lines.get(checker, ())
        lo = getattr(node, "lineno", 0)
        hi = getattr(node, "end_lineno", lo) or lo
        return any(ln in covered for ln in range(lo, hi + 2))


def iter_python_files(paths: Sequence[str]) -> Iterable[str]:
    for p in paths:
        path = Path(p)
        if path.is_dir():
            yield from (str(f) for f in sorted(path.rglob("*.py")))
        elif path.suffix == ".py":
            yield str(path)


def dotted_name(node: ast.AST) -> str:
    """'np.asarray' for Attribute chains, 'int' for Names, '' otherwise."""
    parts: List[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return ""


Checker = Callable[[SourceFile], List[Finding]]


def run_checkers(
    paths: Sequence[str],
    checkers: Dict[str, Checker],
) -> tuple:
    """Run every checker over every file. Returns
    ``(active_findings, suppressed_findings, errors)`` where suppressed
    findings are the pragma-annotated ones (reported for transparency,
    not failures) and errors are unparseable files / empty-reason pragmas
    (always failures)."""
    active: List[Finding] = []
    suppressed: List[Finding] = []
    errors: List[Finding] = []
    for path in iter_python_files(paths):
        try:
            sf = SourceFile.parse(path)
        except SyntaxError as exc:
            errors.append(Finding("pragma", "PARSE", path,
                                  exc.lineno or 0, f"syntax error: {exc.msg}"))
            continue
        for p in sf.empty_pragmas:
            errors.append(Finding(
                "pragma", "PRAGMA000", path, p.line,
                f"'# {p.checker}:' pragma has no reason — every intentional "
                f"violation must carry a justification"))
        for name, checker in checkers.items():
            for f in checker(sf):
                node = _AnchorNode(f.line, f.end_line or f.line)
                if sf.is_suppressed(f.checker, node):
                    suppressed.append(f)
                else:
                    active.append(f)
    return active, suppressed, errors


class _AnchorNode:
    """Minimal line-anchor shim for suppression checks on a Finding."""

    def __init__(self, line: int, end_line: int):
        self.lineno = line
        self.end_lineno = end_line


def finding(checker: str, code: str, sf: SourceFile, node: ast.AST,
            message: str) -> Finding:
    return Finding(checker, code, sf.path, getattr(node, "lineno", 0),
                   message, getattr(node, "end_lineno", 0) or 0)
