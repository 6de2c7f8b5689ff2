"""Config-knob checker: TpuConfig fields ↔ README knob reference.

Twelve PRs of knob growth left the `tpu:` config section documented by
scattered prose: a knob a reader cannot find might as well not exist,
and a documented knob that nothing reads is advice that silently does
nothing. This flat pass cross-references three sets — the `TpuConfig`
dataclass fields (the registry: `provider/config.py` rejects unknown
keys against it), the `tpu.<name>` mentions in README.md, and the
attribute/getattr read sites across `symmetry_tpu/` — and flags every
pairwise drift:

  K601  knob read by the engine/provider but never documented: no
        `tpu.<name>` mention anywhere in README.md
  K602  README documents a `tpu.<name>` that is not a TpuConfig field —
        stale docs (the config loader would reject the key)
  K603  TpuConfig field nothing reads — a dead knob (or a checker-
        invisible read; fix the idiom or prune the field)

A "read" is `X.field` / `getattr(X, "field", ...)` where X's dotted
receiver path has a segment containing "tpu" (`tpu_cfg.role`,
`config.tpu.mesh`, `self._tpu.decode_block`) — the idiom every knob
consumer in the repo uses. Sub-keys of dict-valued knobs
(`tpu.disagg.peer`) resolve to their first segment.

Pure stdlib, no JAX import — the CI gate runs before `pip install`.
"""

from __future__ import annotations

import ast
import os
import re

from symmetry_tpu_torch.analysis.core import (
    CheckerSpec,
    Finding,
    Project,
    const_str,
    dotted_name,
)

NAME = "knobs"
GROUP = ("symmetry_tpu_torch/*.py",)

# `tpu.<name>` not inside a longer dotted/word run — `symmetry_tpu.engine`
# is a module path, not a knob.
_DOC_RE = re.compile(r"(?<![\w.])tpu\.([a-z_][a-z_0-9]*)")


def _tpu_fields(project: Project) -> tuple[str, dict[str, int]]:
    """(defining file rel path, {field: line}) of the TpuConfig
    dataclass; empty when no scanned file defines it (fixture trees in
    tests stay self-contained)."""
    for sf in project.files:
        if sf.tree is None:
            continue
        for node in sf.tree.body:
            if isinstance(node, ast.ClassDef) and node.name == "TpuConfig":
                fields = {s.target.id: s.lineno for s in node.body
                          if isinstance(s, ast.AnnAssign)
                          and isinstance(s.target, ast.Name)}
                return sf.rel, fields
    return "", {}


def _tpu_receiver(path: str | None) -> bool:
    return path is not None and any("tpu" in seg.lower()
                                    for seg in path.split("."))


def _read_sites(project: Project, fields: dict[str, int]) -> set[str]:
    reads: set[str] = set()
    for sf in project.select(GROUP):
        for node in ast.walk(sf.tree):
            if isinstance(node, ast.Attribute) and node.attr in fields \
                    and _tpu_receiver(dotted_name(node.value)):
                reads.add(node.attr)
            elif isinstance(node, ast.Call) and len(node.args) >= 2 \
                    and dotted_name(node.func) == "getattr" \
                    and _tpu_receiver(dotted_name(node.args[0])):
                name = const_str(node.args[1])
                if name in fields:
                    reads.add(name)
    return reads


def check(project: Project) -> list[Finding]:
    reg_path, fields = _tpu_fields(project)
    readme = os.path.join(project.root, "README.md")
    if not fields or not os.path.exists(readme):
        return []
    with open(readme, encoding="utf-8") as fh:
        doc_lines = fh.read().splitlines()
    documented: dict[str, int] = {}
    for i, line in enumerate(doc_lines, 1):
        for m in _DOC_RE.finditer(line):
            documented.setdefault(m.group(1), i)
    reads = _read_sites(project, fields)

    findings: list[Finding] = []
    for f in sorted(reads - set(documented)):
        findings.append(Finding(
            checker=NAME, code="K601", path=reg_path, line=fields[f],
            symbol=f"tpu.{f}",
            message=f"knob `tpu.{f}` is read by the code but README.md "
                    f"never mentions it — document it in the knob "
                    f"reference"))
    for name in sorted(set(documented) - set(fields)):
        findings.append(Finding(
            checker=NAME, code="K602", path="README.md",
            line=documented[name], symbol=f"tpu.{name}",
            message=f"README documents `tpu.{name}` but TpuConfig has "
                    f"no such field — the config loader rejects it; "
                    f"fix or prune the doc"))
    for f in sorted(set(fields) - reads):
        findings.append(Finding(
            checker=NAME, code="K603", path=reg_path, line=fields[f],
            symbol=f"tpu.{f}",
            message=f"TpuConfig field `{f}` is never read anywhere in "
                    f"symmetry_tpu_torch/ — a dead knob (or a read idiom this "
                    f"checker cannot see; use `<tpu receiver>.{f}`)"))
    return findings


SPEC = CheckerSpec(
    name=NAME,
    doc="tpu.* knobs: TpuConfig fields ↔ README docs ↔ read sites",
    run=check,
    codes=("K601", "K602", "K603"),
)
