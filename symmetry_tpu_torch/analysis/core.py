"""Shared infrastructure for the symlint checker suite.

The project's correctness invariants — wire-protocol agreement between
the engine host and the provider backend, lock discipline across the
threaded engine tier, compile-cache stability inside jit-traced
functions, fault-seam name agreement between guards and arming sites —
were all enforced at runtime (a drifted op name hangs a stream; a
missed lock loses a counter increment; a data-dependent branch
recompiles mid-traffic). Each checker in this package makes one of
those invariants *static*: an AST pass over the repo that fails CI on
drift instead of waiting for it to surface under load.

This module holds what every checker shares:

  - `SourceFile`: one parsed file (path, source, AST with parent links)
  - `Finding`: one diagnostic, with a line-number-free `fingerprint`
    so baseline suppressions survive unrelated edits
  - `Baseline`: the suppression file (JSON, one justified entry per
    intentionally-accepted finding)
  - `Project`: the scanned file set plus the cross-file helpers
    (glob-scoped file selection, constant-registry extraction)
  - small AST helpers (`const_str`, `call_name`, `attach_parents`)

Checkers are cross-file by design (the wire-contract checker needs
producer AND consumer sets), so each one receives the whole `Project`
and returns a list of `Finding`s — there is no per-file visitor
contract to fight when an invariant spans processes.
"""

from __future__ import annotations

import ast
import fnmatch
import json
import os
from dataclasses import dataclass, field
from typing import Any, Callable, Iterable

# Directories never worth parsing (build junk, caches, vendored code —
# a repo-local virtualenv holds thousands of third-party files no
# checker scopes, but walking them would turn the seconds-long gate
# into minutes).
_SKIP_DIRS = {".git", "__pycache__", ".ruff_cache", "build", "dist",
              ".eggs", "node_modules", ".claude", ".venv", "venv",
              ".tox", ".mypy_cache", "site-packages", ".pytest_cache"}


# --------------------------------------------------------------- findings


@dataclass
class Finding:
    """One diagnostic from one checker.

    `symbol` is the stable identity of WHAT drifted (an op name, a seam
    name, a `Class.attr`), not where: the fingerprint is built from it
    so a baseline entry keeps matching when unrelated edits move the
    line. Sort/compare order is file order, which is what both output
    modes print."""

    checker: str          # e.g. "wire-contract"
    code: str             # e.g. "W102"
    path: str             # repo-relative, "/" separated
    line: int
    message: str
    symbol: str = ""      # stable subject (op/seam/attr name)
    baselined: bool = False

    @property
    def fingerprint(self) -> str:
        return f"{self.code}:{self.path}:{self.symbol or self.message}"

    def to_dict(self) -> dict[str, Any]:
        return {"checker": self.checker, "code": self.code,
                "path": self.path, "line": self.line,
                "message": self.message, "symbol": self.symbol,
                "fingerprint": self.fingerprint,
                "baselined": self.baselined}

    def render(self) -> str:
        tag = " (baselined)" if self.baselined else ""
        return (f"{self.path}:{self.line}: {self.code} "
                f"[{self.checker}] {self.message}{tag}")


class Baseline:
    """The suppression file: a JSON list of justified fingerprints.

    Shape (reasons are mandatory — an unexplained suppression is just
    drift with a paper trail):

        {"version": 1,
         "suppressions": [
            {"fingerprint": "C202:path.py:Cls._attr", "reason": "..."}]}

    `match()` marks a finding baselined; `unused()` reports entries
    that matched nothing this run, so stale suppressions surface
    instead of silently shadowing future regressions."""

    def __init__(self, entries: list[dict[str, str]] | None = None) -> None:
        self.entries = entries or []
        self._by_fp = {e["fingerprint"]: e for e in self.entries
                       if isinstance(e, dict) and "fingerprint" in e}
        self._hit: set[str] = set()

    @classmethod
    def load(cls, path: str) -> "Baseline":
        with open(path, encoding="utf-8") as fh:
            data = json.load(fh)
        entries = data.get("suppressions", [])
        if not isinstance(entries, list):
            raise ValueError(f"{path}: 'suppressions' must be a list")
        for e in entries:
            if not isinstance(e, dict) or not e.get("fingerprint"):
                raise ValueError(f"{path}: bad suppression entry {e!r}")
            if not e.get("reason"):
                raise ValueError(
                    f"{path}: suppression {e['fingerprint']!r} has no "
                    f"reason — justify it or fix the finding")
        return cls(entries)

    def match(self, finding: Finding) -> bool:
        if finding.fingerprint in self._by_fp:
            self._hit.add(finding.fingerprint)
            return True
        return False

    def unused(self) -> list[str]:
        return [fp for fp in self._by_fp if fp not in self._hit]


# ------------------------------------------------------------ source files


@dataclass
class SourceFile:
    """One parsed file. `tree` is None when the file does not parse —
    checkers skip it (a syntax error is the byte-compile step's job,
    not ours)."""

    path: str             # absolute
    rel: str              # repo-relative, "/" separated
    source: str
    tree: ast.Module | None = None

    def matches(self, patterns: Iterable[str]) -> bool:
        return any(fnmatch.fnmatch(self.rel, p) for p in patterns)


def attach_parents(tree: ast.AST) -> None:
    """Annotate every node with `.sym_parent` — several checkers need
    to know the context an expression sits in (dict value vs compare
    operand, call func vs argument)."""
    for node in ast.walk(tree):
        for child in ast.iter_child_nodes(node):
            child.sym_parent = node  # type: ignore[attr-defined]


def parse_source(path: str, rel: str, source: str) -> SourceFile:
    sf = SourceFile(path=path, rel=rel, source=source)
    try:
        sf.tree = ast.parse(source, filename=rel)
    except SyntaxError:
        sf.tree = None
    else:
        attach_parents(sf.tree)
    return sf


def load_file(root: str, rel: str) -> SourceFile:
    path = os.path.join(root, rel)
    with open(path, encoding="utf-8") as fh:
        source = fh.read()
    return parse_source(path, rel.replace(os.sep, "/"), source)


def iter_py_files(root: str) -> list[str]:
    """Repo-relative paths of every .py file under `root`, skipping
    VCS/build directories. Sorted for deterministic output."""
    out: list[str] = []
    for dirpath, dirnames, filenames in os.walk(root):
        dirnames[:] = sorted(d for d in dirnames if d not in _SKIP_DIRS)
        for name in sorted(filenames):
            if name.endswith(".py"):
                rel = os.path.relpath(os.path.join(dirpath, name), root)
                out.append(rel.replace(os.sep, "/"))
    return out


# ----------------------------------------------------------- AST helpers


def const_str(node: ast.AST | None) -> str | None:
    """The value of a string-constant node, else None."""
    if isinstance(node, ast.Constant) and isinstance(node.value, str):
        return node.value
    return None


def dotted_name(node: ast.AST) -> str | None:
    """`a.b.c` for Name/Attribute chains, else None."""
    parts: list[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return None


def call_name(node: ast.Call) -> str | None:
    """Dotted name of a call's callee (`time.sleep`, `FAULTS.point`)."""
    return dotted_name(node.func)


# --------------------------------------------------------------- project


class Project:
    """The scanned file set plus shared cross-file lookups."""

    def __init__(self, root: str, files: list[SourceFile]) -> None:
        self.root = root
        self.files = files

    @classmethod
    def scan(cls, root: str, rels: list[str] | None = None) -> "Project":
        rels = rels if rels is not None else iter_py_files(root)
        return cls(root, [load_file(root, r) for r in rels])

    def select(self, patterns: Iterable[str]) -> list[SourceFile]:
        pats = list(patterns)
        return [f for f in self.files if f.tree is not None
                and f.matches(pats)]

    def class_constants(self, class_name: str) -> dict[str, str]:
        """`NAME -> "value"` for a module-level class of string
        constants (the HostOp / MessageKey registries in
        protocol/keys.py). Empty when no scanned file defines it —
        checkers then skip registry-dependent rules, which keeps
        fixture trees in tests self-contained."""
        for sf in self.files:
            if sf.tree is None:
                continue
            for node in sf.tree.body:
                if (isinstance(node, ast.ClassDef)
                        and node.name == class_name):
                    out: dict[str, str] = {}
                    for stmt in node.body:
                        if (isinstance(stmt, ast.Assign)
                                and len(stmt.targets) == 1
                                and isinstance(stmt.targets[0], ast.Name)):
                            val = const_str(stmt.value)
                            if val is not None:
                                out[stmt.targets[0].id] = val
                    return out
        return {}


# ---------------------------------------------------------------- runner


@dataclass
class CheckerSpec:
    name: str
    doc: str
    run: Callable[[Project], list[Finding]]
    codes: tuple[str, ...] = field(default_factory=tuple)


def run_suite(project: Project, checkers: Iterable[CheckerSpec],
              baseline: Baseline | None = None) -> list[Finding]:
    """Run every checker, mark baselined findings, return file order."""
    findings: list[Finding] = []
    for spec in checkers:
        findings.extend(spec.run(project))
    if baseline is not None:
        for f in findings:
            f.baselined = baseline.match(f)
    findings.sort(key=lambda f: (f.path, f.line, f.code, f.symbol))
    return findings
