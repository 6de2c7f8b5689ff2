"""Metric-name checker: registry ↔ emission-site agreement.

Metric names are string-matched at scrape time, the same failure shape
as a wire op: a typo'd name does not error — it creates a second,
forever-empty family, and the dashboard panel (or the SLO monitor, or
symtop's column) quietly reads zeros. The `MetricName` registry in
utils/metrics.py is the one place names live; this checker makes the
agreement static:

  M101  raw metric-name string literal at an emission site where a
        `MetricName` constant exists — emitters must go through the
        registry, which is what kills `sym_provider_requests_total` vs
        `sym_provider_request_total` spelling drift
  M102  name emitted (a `METRICS.counter/gauge/histogram(...)` call)
        but not registered in `MetricName` at all — including a
        reference to a nonexistent attribute (`MetricName.TYPO`), which
        is an AttributeError waiting on first emission
  M103  name registered in `MetricName` but never emitted anywhere in
        the scanned group — dead registry weight, or (worse) the
        emitter was renamed away from it and some consumer still
        queries the old name

Emission extraction: calls whose callee is `<...>.METRICS.counter`,
`.gauge`, or `.histogram` with a resolvable first argument (string
constant or `MetricName.X`). Handles created through the module-global
`METRICS` are the project idiom (registration IS the emission site the
checker pins — the returned handle's `.inc()/.observe()` calls carry no
name). Tests are deliberately outside the group: they pin names as raw
literals on purpose, independent of the constants.
"""

from __future__ import annotations

import ast

from symmetry_tpu_torch.analysis.core import (
    CheckerSpec,
    Finding,
    Project,
    const_str,
    dotted_name,
)

NAME = "metric-names"

# Every production emitter: the whole package (fnmatch `*` crosses
# path separators). tools/ and tests/ stay out — tools only PARSE
# exposition text, and tests pin names as deliberate raw literals.
EMIT_GROUP = ("symmetry_tpu_torch/*.py",)

_REGISTRY_CLASS = "MetricName"
_EMIT_METHODS = {"counter", "gauge", "histogram"}
_RECEIVER = "METRICS"


def _registry_lines(project: Project) -> dict[str, tuple[str, int]]:
    """attr value -> (file, line) for the MetricName class body — M103
    findings anchor at the registered-but-dead assignment itself."""
    out: dict[str, tuple[str, int]] = {}
    for sf in project.files:
        if sf.tree is None:
            continue
        for node in sf.tree.body:
            if isinstance(node, ast.ClassDef) and node.name == _REGISTRY_CLASS:
                for stmt in node.body:
                    if (isinstance(stmt, ast.Assign)
                            and len(stmt.targets) == 1
                            and isinstance(stmt.targets[0], ast.Name)):
                        val = const_str(stmt.value)
                        if val is not None:
                            out[val] = (sf.rel, stmt.lineno)
                return out
    return out


def check(project: Project) -> list[Finding]:
    registry = project.class_constants(_REGISTRY_CLASS)
    if not registry:
        return []  # fixture tree without the registry — nothing to pin
    values = set(registry.values())
    by_value = {v: k for k, v in registry.items()}
    findings: list[Finding] = []
    emitted: set[str] = set()

    for sf in project.select(EMIT_GROUP):
        for node in ast.walk(sf.tree):
            if not (isinstance(node, ast.Call)
                    and isinstance(node.func, ast.Attribute)
                    and node.func.attr in _EMIT_METHODS and node.args):
                continue
            recv = dotted_name(node.func.value)
            if recv is None or recv.split(".")[-1] != _RECEIVER:
                continue
            arg = node.args[0]
            raw = const_str(arg)
            if raw is not None:
                emitted.add(raw)
                if raw in values:
                    findings.append(Finding(
                        checker=NAME, code="M101", path=sf.rel,
                        line=arg.lineno, symbol=raw,
                        message=f'raw metric-name literal "{raw}" — use '
                                f'MetricName.{by_value[raw]} from '
                                f'symmetry_tpu_torch/utils/metrics.py'))
                else:
                    findings.append(Finding(
                        checker=NAME, code="M102", path=sf.rel,
                        line=arg.lineno, symbol=raw,
                        message=f'metric "{raw}" is emitted here but not '
                                f'registered in MetricName — a typo makes '
                                f'a silently-empty family, register it'))
                continue
            dn = dotted_name(arg)
            if dn is None:
                continue  # computed name (registry internals) — unscoped
            head, _, attr = dn.rpartition(".")
            if head.split(".")[-1] != _REGISTRY_CLASS:
                continue
            if attr in registry:
                emitted.add(registry[attr])
            else:
                findings.append(Finding(
                    checker=NAME, code="M102", path=sf.rel,
                    line=arg.lineno, symbol=dn,
                    message=f'{dn} does not exist in the MetricName '
                            f'registry — AttributeError on first '
                            f'emission'))

    lines = _registry_lines(project)
    for value in sorted(values - emitted):
        rel, lineno = lines.get(value, ("symmetry_tpu_torch/utils/metrics.py", 1))
        findings.append(Finding(
            checker=NAME, code="M103", path=rel, line=lineno,
            symbol=value,
            message=f'metric "{value}" is registered in MetricName but '
                    f'never emitted — dead registry entry or a renamed '
                    f'emitter left consumers querying an empty family'))
    return findings


SPEC = CheckerSpec(
    name=NAME,
    doc="MetricName registry / emission-site agreement",
    run=check,
    codes=("M101", "M102", "M103"),
)
