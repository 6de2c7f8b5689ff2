"""Fault-seam checker: arming sites and guard sites must agree.

The fault-injection layer (utils/faults.py) is name-matched string
plumbing end to end: a seam armed as `host.pipe_write=crash` only does
anything because some call site guards `FAULTS.point("host.pipe_write")`.
Rename either side and nothing errors — the chaos test silently tests
nothing, which is worse than no test. This checker cross-references
the two sides:

  S401  a seam is ARMED somewhere (SYMMETRY_FAULTS env string, a
        provider-config `faults:` mapping, a `FAULTS.load(...)` call)
        but no `FAULTS.point/apoint` guard with that name exists in
        the package — the fault can never fire
  S402  a guard site exists in the package but nothing in the repo
        ever arms that seam — the recovery path behind it is untested

Arming extraction understands the three real shapes:

  - `FAULTS.load("seam=action@trigger;seam2=…")` env-grammar strings
  - `FAULTS.load({"seam": "action"})` mapping literals
  - `{"faults": {"seam": "action"}}` entries inside any config dict
    literal (the provider-yaml shape tests/tools build inline)
  - string literals that fully parse under the SYMMETRY_FAULTS grammar
    (catches specs routed through env dicts / subprocess plumbing)

A file that arms a seam AND contains its own guard/fire call for that
name is self-contained (the injector's own unit tests) and exempt from
S401 — it is exercising the mechanism, not a production seam.
"""

from __future__ import annotations

import ast
import re

from symmetry_tpu_torch.analysis.core import (
    CheckerSpec,
    Finding,
    Project,
    SourceFile,
    call_name,
    const_str,
)

NAME = "fault-seam"

# Guard sites live in production code (package + the smoke drivers'
# protocol-faithful stand-ins).
GUARD_SCOPE = ("symmetry_tpu_torch/**", "tools/*.py", "tests/fake_host.py")
# Arming happens anywhere: tests, tools, package defaults.
ARM_SCOPE = ("symmetry_tpu_torch/**", "tools/*.py", "tests/**")

_GUARD_METHODS = {"point", "apoint"}
_FIRE_METHODS = {"point", "apoint", "fire"}

# One `seam=action[@trigger]` entry of the SYMMETRY_FAULTS grammar. The
# seam shape is pinned to dotted lower_snake names (one or more dots —
# `disagg.net.drop_link` is three segments) so ordinary `key=value`
# strings elsewhere in the repo can never parse as specs.
_SPEC_ENTRY = re.compile(
    r"^(?P<seam>[a-z_][a-z0-9_]*(?:\.[a-z_][a-z0-9_]*)+)="
    r"(?P<action>crash|hang|delay|error|drop_frame)"
    r"(?:\([^)]*\))?(?:@[a-z=0-9_.]+)?$")


def _parse_spec_string(s: str) -> set[str]:
    """Seam names from an env-grammar string; empty set when the string
    is not entirely spec-shaped."""
    entries = [e.strip() for e in s.split(";") if e.strip()]
    if not entries:
        return set()
    seams: set[str] = set()
    for e in entries:
        m = _SPEC_ENTRY.match(e)
        if m is None:
            return set()
        seams.add(m.group("seam"))
    return seams


def _seams_from_dict(node: ast.Dict) -> set[str]:
    """Seam names when a dict literal is fault-mapping-shaped: every
    key a dotted seam string, every value a parseable action spec (or
    list thereof)."""
    if not node.keys:
        return set()
    seams: set[str] = set()
    for k, v in zip(node.keys, node.values):
        key = const_str(k)
        if key is None or "." not in key:
            return set()
        vals = (v.elts if isinstance(v, (ast.Tuple, ast.List)) else [v])
        if not vals:
            return set()
        for one in vals:
            spec = const_str(one)
            if spec is None or not _parse_spec_string(f"{key}={spec}"):
                return set()
        seams.add(key)
    return seams


def _local_injector_arg(node: ast.AST) -> bool:
    """Is this node an argument of `<local>.load(...)` / `parse_rule(...)`
    on something that is NOT the process-global FAULTS? Those arm a
    throwaway injector instance (the injector's own unit tests), not a
    production seam."""
    parent = getattr(node, "sym_parent", None)
    while parent is not None and not isinstance(parent, ast.Call):
        if isinstance(parent, (ast.stmt, ast.Module)):
            return False
        parent = getattr(parent, "sym_parent", None)
    if not isinstance(parent, ast.Call):
        return False
    cn = call_name(parent)
    if cn is None:
        return False
    leaf = cn.split(".")[-1]
    if leaf == "parse_rule":
        return True
    if leaf == "load" and not cn.endswith("FAULTS.load"):
        return True
    return False


def _collect_armed(sf: SourceFile) -> dict[str, int]:
    """seam -> first arming line in one file."""
    armed: dict[str, int] = {}

    def note(seams: set[str], line: int) -> None:
        for s in seams:
            armed.setdefault(s, line)

    for node in ast.walk(sf.tree):
        if isinstance(node, ast.Call):
            cn = call_name(node)
            if cn is not None and cn.endswith("FAULTS.load") and node.args:
                arg = node.args[0]
                s = const_str(arg)
                if s is not None:
                    note(_parse_spec_string(s), node.lineno)
                elif isinstance(arg, ast.Dict):
                    note(_seams_from_dict(arg), node.lineno)
        elif isinstance(node, ast.Dict):
            if _local_injector_arg(node):
                continue
            # A fault-mapping-shaped dict literal arms its seams
            # whether it sits under a "faults" config key or travels
            # through a variable first — the dotted-seam-key +
            # action-grammar-value shape is distinctive enough that
            # nothing else in the repo parses as one.
            note(_seams_from_dict(node), node.lineno)
        elif isinstance(node, ast.Constant) and isinstance(node.value, str):
            # Bare spec strings (env plumbing): only full-grammar
            # matches count, so prose never does; strings feeding a
            # local injector instance are the parser's own tests.
            if ("=" in node.value and "." in node.value
                    and not _local_injector_arg(node)):
                note(_parse_spec_string(node.value), node.lineno)
    return armed


def _collect_guards(sf: SourceFile, methods: set[str],
                    any_receiver: bool = False) -> dict[str, int]:
    """seam -> first guard line for FAULTS.<method>("seam") calls.
    `any_receiver=True` also accepts local injector instances
    (`inj.point(...)`) — used only for the self-containment check,
    never to satisfy a production guard."""
    guards: dict[str, int] = {}
    for node in ast.walk(sf.tree):
        if not isinstance(node, ast.Call):
            continue
        cn = call_name(node)
        if cn is None or cn.split(".")[-1] not in methods:
            continue
        head = cn.rsplit(".", 1)[0].split(".")[-1]
        if head != "FAULTS" and not (any_receiver and head):
            continue
        if node.args:
            seam = const_str(node.args[0])
            if seam is not None:
                guards.setdefault(seam, node.lineno)
    return guards


def check(project: Project) -> list[Finding]:
    findings: list[Finding] = []

    guard_files = project.select(GUARD_SCOPE)
    arm_files = project.select(ARM_SCOPE)

    guards: dict[str, tuple[str, int]] = {}
    for sf in guard_files:
        for seam, line in _collect_guards(sf, _GUARD_METHODS).items():
            guards.setdefault(seam, (sf.rel, line))

    armed: dict[str, tuple[str, int]] = {}
    self_contained: set[str] = set()
    for sf in arm_files:
        file_armed = _collect_armed(sf)
        if not file_armed:
            continue
        # Self-contained file: arms AND fires the same seam itself
        # (injector unit tests) — those seams are not production seams.
        own_fires = _collect_guards(sf, _FIRE_METHODS, any_receiver=True)
        for seam, line in file_armed.items():
            if seam in own_fires:
                self_contained.add(seam)
            armed.setdefault(seam, (sf.rel, line))

    for seam, (rel, line) in sorted(armed.items()):
        if seam in guards or seam in self_contained:
            continue
        findings.append(Finding(
            checker=NAME, code="S401", path=rel, line=line, symbol=seam,
            message=(f'seam "{seam}" is armed here but no '
                     f'FAULTS.point/apoint guard with that name exists '
                     f'in the package — the fault can never fire')))
    for seam, (rel, line) in sorted(guards.items()):
        if seam in armed:
            continue
        findings.append(Finding(
            checker=NAME, code="S402", path=rel, line=line, symbol=seam,
            message=(f'seam "{seam}" is guarded here but nothing in '
                     f'tests/tools/configs ever arms it — the recovery '
                     f'path behind it is untested')))
    return findings


SPEC = CheckerSpec(
    name=NAME,
    doc="SYMMETRY_FAULTS arming sites ↔ FAULTS.point guard sites",
    run=check,
    codes=("S401", "S402"),
)
