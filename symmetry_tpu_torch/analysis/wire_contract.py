"""Wire-contract checker: host-pipe ops and MessageKey vocabulary.

The engine host and the provider backend speak a hand-rolled JSON-lines
protocol (`{"op": ...}` frames, engine/host.py docstring is the spec);
the provider/client/server tier speaks `MessageKey` frames. Both are
string-matched at runtime, so a renamed or misspelled op does not
error — the frame is silently ignored and the stream hangs until a
watchdog fires. This checker makes the contract static:

  W101  raw op string literal where a `HostOp` constant exists
        (producers and consumers must go through protocol/keys.py —
        the centralization that kills `"op": "adopt"` vs `"op":"adopt"`
        spelling drift)
  W102  op produced (a `{"op": X}` frame is built) but no consumer in
        the scanned group ever dispatches on it
  W103  op consumed (an `op == X` / `.get("op") == X` dispatch exists)
        but nothing in the group ever produces it
  W104  op name not registered in `HostOp` at all
  W105  raw string literal used where a `MessageKey` constant exists
        (`msg.key == "ping"`, `peer.send("pong", ...)`)
  W106  MessageKey sent somewhere but handled nowhere in the tier
  W107  MessageKey handled somewhere but sent nowhere in the tier

The handoff-LINK protocol (engine/disagg/net.py envelope headers,
`LinkOp` registry) is checked with the same W101–W104 semantics over
its own group (LINK_GROUP): the link ops deliberately reuse some HostOp
value strings (a link `submit` forwards a host `submit`), so each
registry is resolved only against its own `<Class>.<ATTR>` references —
a `LinkOp.X` attribute is invisible to the HostOp scan and vice versa,
and raw literals are flagged against whichever registry owns the group.

Producer extraction: any dict literal with an `"op"` key (string
constant or `HostOp.X`). Consumer extraction: comparisons and
membership tests where one side is an op constant and the other is an
op-shaped expression (a name/attribute ending in `op`, or a
`.get("op")` call). Cross-checking runs over the whole scanned group at
once, so moving a producer without its consumer — the exact drift that
bit the adopt path — fails CI instead of hanging a stream.

Keys that are deliberately one-sided (e.g. emitted for an external
consumer) belong in the baseline file with a reason, not out of the
scan scope.
"""

from __future__ import annotations

import ast
from dataclasses import dataclass, field

from symmetry_tpu_torch.analysis.core import (
    CheckerSpec,
    Finding,
    Project,
    SourceFile,
    const_str,
    dotted_name,
)

NAME = "wire-contract"

# The host-pipe protocol group: every file that builds or dispatches on
# `{"op": ...}` frames. tests/fake_host.py is included on purpose — it
# is the protocol-faithful stand-in the chaos suite trusts, so it must
# drift WITH the real host, not away from it.
OP_GROUP = (
    "symmetry_tpu_torch/engine/host.py",
    "symmetry_tpu_torch/engine/disagg/*.py",
    "symmetry_tpu_torch/provider/backends/*.py",
    "tools/*.py",
    "tests/fake_host.py",
)

# The handoff-link protocol group (LinkOp registry): both endpoints of
# the cross-machine link live here; anything that grows a new link-op
# producer or consumer belongs in this set.
LINK_GROUP = (
    "symmetry_tpu_torch/engine/disagg/net.py",
    "symmetry_tpu_torch/engine/disagg/node.py",
)

# The MessageKey tier: everything that sends or handles peer frames.
KEY_GROUP = (
    "symmetry_tpu_torch/provider/*.py",
    "symmetry_tpu_torch/provider/backends/*.py",
    "symmetry_tpu_torch/client/*.py",
    "symmetry_tpu_torch/server/*.py",
    "symmetry_tpu_torch/network/*.py",
)

# `.send(key, ...)`-shaped producer methods and `.key` consumer
# attribute for the MessageKey tier.
_SEND_METHODS = {"send"}

_OP_REGISTRY_CLASS = "HostOp"
_LINK_REGISTRY_CLASS = "LinkOp"
_KEY_REGISTRY_CLASS = "MessageKey"


@dataclass
class _OpUse:
    value: str
    line: int
    raw: bool             # spelled as a string literal (not a constant)
    file: SourceFile = field(repr=False, default=None)  # type: ignore


def _op_value(node: ast.AST, registry: dict[str, str],
              registry_class: str,
              missing: list | None = None) -> tuple[str | None, bool]:
    """Resolve an op-valued expression: a string constant (raw=True) or
    a `HostOp.X` attribute (raw=False). (None, False) when neither.

    A reference to a registry attribute that does NOT exist
    (`HostOp.EVNT`) is exactly the typo class this checker exists for —
    it cannot be silently dropped, so it is appended to `missing` as
    (dotted name, line) for the caller to flag."""
    s = const_str(node)
    if s is not None:
        return s, True
    if isinstance(node, ast.Attribute):
        dn = dotted_name(node)
        if dn is not None:
            head, _, attr = dn.rpartition(".")
            if head.split(".")[-1] == registry_class:
                if registry and attr not in registry \
                        and missing is not None:
                    missing.append((dn, node.lineno))
                return registry.get(attr), False
    return None, False


def _is_op_shaped(node: ast.AST) -> bool:
    """Does this expression look like it carries an op name at runtime?
    A bare name/attribute called `op`/`opname`, a `.get("op")` call, or
    a `msg["op"]` subscript."""
    dn = dotted_name(node)
    if dn is not None and dn.split(".")[-1] in ("op", "opname"):
        return True
    if (isinstance(node, ast.Call) and isinstance(node.func, ast.Attribute)
            and node.func.attr == "get" and node.args
            and const_str(node.args[0]) == "op"):
        return True
    if isinstance(node, ast.Subscript) and const_str(node.slice) == "op":
        return True
    return False


def _collect_ops(sf: SourceFile, registry: dict[str, str],
                 missing: list, registry_class: str = _OP_REGISTRY_CLASS
                 ) -> tuple[list[_OpUse], list[_OpUse]]:
    """(produced, consumed) op uses in one file, resolved against ONE
    registry class (HostOp or LinkOp — references to the other class
    are invisible here and scanned by their own group); nonexistent
    registry attributes land in `missing` as (file, dotted, line)."""
    produced: list[_OpUse] = []
    consumed: list[_OpUse] = []
    miss: list = []
    for node in ast.walk(sf.tree):
        if isinstance(node, ast.Dict):
            for k, v in zip(node.keys, node.values):
                if const_str(k) == "op":
                    val, raw = _op_value(v, registry,
                                         registry_class, miss)
                    if val is not None:
                        produced.append(_OpUse(val, v.lineno, raw, sf))
        elif isinstance(node, ast.Assign):
            # m["op"] = HostOp.STATS — the reply-in-place producer shape
            for t in node.targets:
                if (isinstance(t, ast.Subscript)
                        and const_str(t.slice) == "op"):
                    val, raw = _op_value(node.value, registry,
                                         registry_class, miss)
                    if val is not None:
                        produced.append(
                            _OpUse(val, node.value.lineno, raw, sf))
        elif isinstance(node, ast.Compare):
            # op == "submit" | "submit" == op | msg.get("op") == HostOp.X
            # | op in ("event", "events")
            sides = [node.left] + list(node.comparators)
            if not any(_is_op_shaped(s) for s in sides):
                continue
            for side in sides:
                if _is_op_shaped(side):
                    continue
                val, raw = _op_value(side, registry,
                                     registry_class, miss)
                if val is not None:
                    consumed.append(_OpUse(val, side.lineno, raw, sf))
                elif isinstance(side, (ast.Tuple, ast.List, ast.Set)):
                    for elt in side.elts:
                        val, raw = _op_value(elt, registry,
                                             registry_class, miss)
                        if val is not None:
                            consumed.append(
                                _OpUse(val, elt.lineno, raw, sf))
    missing.extend((sf, dn, ln) for dn, ln in miss)
    return produced, consumed


def _collect_keys(sf: SourceFile, registry: dict[str, str],
                  missing: list) -> tuple[list[_OpUse], list[_OpUse]]:
    """(sent, handled) MessageKey uses in one file; nonexistent
    registry attributes land in `missing`."""
    values = set(registry.values())
    miss: list = []
    sent: list[_OpUse] = []
    handled: list[_OpUse] = []
    for node in ast.walk(sf.tree):
        if isinstance(node, ast.Call):
            if (isinstance(node.func, ast.Attribute)
                    and node.func.attr in _SEND_METHODS and node.args):
                val, raw = _op_value(node.args[0], registry,
                                     _KEY_REGISTRY_CLASS, miss)
                if val is not None and (not raw or val in values):
                    sent.append(_OpUse(val, node.args[0].lineno, raw, sf))
        elif isinstance(node, ast.Compare):
            sides = [node.left] + list(node.comparators)
            if not any(dotted_name(s) is not None
                       and dotted_name(s).split(".")[-1] == "key"
                       for s in sides):
                continue
            for side in sides:
                dn = dotted_name(side)
                if dn is not None and dn.split(".")[-1] == "key":
                    continue
                elts = (side.elts
                        if isinstance(side, (ast.Tuple, ast.List, ast.Set))
                        else [side])
                for elt in elts:
                    val, raw = _op_value(elt, registry,
                                         _KEY_REGISTRY_CLASS, miss)
                    if val is not None and (not raw or val in values):
                        handled.append(_OpUse(val, elt.lineno, raw, sf))
    missing.extend((sf, dn, ln) for dn, ln in miss)
    return sent, handled


def _missing_findings(missing: list) -> list[Finding]:
    """W104 findings for nonexistent registry attributes (HostOp.EVNT):
    an AttributeError waiting on a rarely-taken dispatch path."""
    return [Finding(
        checker=NAME, code="W104", path=sf.rel, line=ln, symbol=dn,
        message=(f'{dn} does not exist in the registry '
                 f'(symmetry_tpu_torch/protocol/keys.py) — this is an '
                 f'AttributeError waiting on a rare dispatch path'))
        for sf, dn, ln in missing]


def check(project: Project) -> list[Finding]:
    findings: list[Finding] = []
    missing: list = []

    def _finding(code: str, use: _OpUse, msg: str) -> Finding:
        return Finding(checker=NAME, code=code, path=use.file.rel,
                       line=use.line, message=msg, symbol=use.value)

    def _scan_op_group(registry_class: str, group: tuple[str, ...],
                       label: str) -> None:
        """One producer/consumer agreement pass: W101–W104 for one op
        registry over its file group."""
        registry = project.class_constants(registry_class)
        values = set(registry.values())
        produced: list[_OpUse] = []
        consumed: list[_OpUse] = []
        miss: list = []
        for sf in project.select(group):
            p, c = _collect_ops(sf, registry, miss, registry_class)
            produced.extend(p)
            consumed.extend(c)
        findings.extend(_missing_findings(miss))
        for use in produced + consumed:
            if registry and use.raw and use.value in values:
                findings.append(_finding(
                    "W101", use,
                    f'raw op literal "{use.value}" — use '
                    f'{registry_class}.'
                    f'{next(k for k, v in registry.items() if v == use.value)}'
                    f' from symmetry_tpu_torch/protocol/keys.py'))
            if registry and use.value not in values:
                findings.append(_finding(
                    "W104", use,
                    f'op "{use.value}" is not registered in '
                    f'{registry_class} (symmetry_tpu_torch/protocol/keys.py) '
                    f'— unknown wire op'))
        produced_vals = {u.value for u in produced}
        consumed_vals = {u.value for u in consumed}
        for use in produced:
            if use.value not in consumed_vals:
                findings.append(_finding(
                    "W102", use,
                    f'op "{use.value}" is produced here but no consumer '
                    f'in the {label} group dispatches on it — the frame '
                    f'would be silently dropped'))
        for use in consumed:
            if use.value not in produced_vals:
                findings.append(_finding(
                    "W103", use,
                    f'op "{use.value}" is dispatched on here but '
                    f'nothing in the {label} group produces it — dead '
                    f'consumer or renamed producer'))

    # ---- host-pipe ops + handoff-link ops -----------------------------
    _scan_op_group(_OP_REGISTRY_CLASS, OP_GROUP, "host-pipe")
    _scan_op_group(_LINK_REGISTRY_CLASS, LINK_GROUP, "handoff-link")

    # ---- MessageKey tier ---------------------------------------------
    key_registry = project.class_constants(_KEY_REGISTRY_CLASS)
    if key_registry:
        key_values = set(key_registry.values())
        sent: list[_OpUse] = []
        handled: list[_OpUse] = []
        for sf in project.select(KEY_GROUP):
            s, h = _collect_keys(sf, key_registry, missing)
            sent.extend(s)
            handled.extend(h)
        findings.extend(_missing_findings(missing))
        for use in sent + handled:
            if use.raw and use.value in key_values:
                findings.append(_finding(
                    "W105", use,
                    f'raw message-key literal "{use.value}" — use '
                    f'MessageKey.'
                    f'{next(k for k, v in key_registry.items() if v == use.value)}'))
        sent_vals = {u.value for u in sent}
        handled_vals = {u.value for u in handled}
        for use in sent:
            if use.value not in handled_vals:
                findings.append(_finding(
                    "W106", use,
                    f'message key "{use.value}" is sent here but no '
                    f'peer-tier handler compares against it'))
        for use in handled:
            if use.value not in sent_vals:
                findings.append(_finding(
                    "W107", use,
                    f'message key "{use.value}" is handled here but '
                    f'nothing in the tier ever sends it'))
    return findings


SPEC = CheckerSpec(
    name=NAME,
    doc="host-pipe op / MessageKey producer-consumer agreement",
    run=check,
    codes=("W101", "W102", "W103", "W104", "W105", "W106", "W107"),
)
