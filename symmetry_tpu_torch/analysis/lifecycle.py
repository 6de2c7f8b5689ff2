"""Lifecycle checker: paired-resource protocols, path-sensitively.

The repo has three acquire/release disciplines whose misuse is silent
HBM corruption, not an error: the paged KV pool's refcounts
(`BlockPool.alloc` → `unref`/`free`), the pinned radix handles
(`RadixIndex.lookup` → `RadixHit.release`, `plan_insert` →
`InsertPlan.commit`/`abort`), and bare `Lock.acquire` outside `with`.
PR 12's review found the shape this checker exists for: a path — an
exception path — between acquire and release that none of the flat
single-statement checkers could see. Built on analysis/dataflow.py:
every function that acquires is walked path-sensitively, and each
protocol comes from the declarative SPECS table below, so adding the
next paired resource is one tuple, not a new checker.

  L401  handle leaks on a normal path: acquired, then the function
        exits (return/fallthrough) on some path where it was neither
        released nor handed off
  L402  handle leaks on an EXCEPTION path — the PR-12 crash pattern: a
        raise between acquire and release unwinds past the pin
  L403  double release of a non-idempotent release (`commit` after
        commit/abort raises; `Lock.release` on an unlocked lock)
  L404  use after release: the handle is read after `release`/`abort`/
        `commit` resolved it (reading `plan.new_ids` after abort is
        reading freed block ids)

Ownership transfer ends tracking without a finding: returning the
handle, yielding it, storing it into an attribute/container, or
passing the handle itself to any non-release call (the scheduler hands
pinned hits to the engine; the engine releases them — each function is
checked for ITS span of the handle's life). Optional acquires
(`lookup`/`plan_insert` return None on miss) are tracked as
maybe-None; `if h is None` narrows per path, and a maybe-None leak is
reported with "may" phrasing at the same codes.

Pure stdlib, no JAX import — the CI gate runs before `pip install`.
"""

from __future__ import annotations

import ast
from dataclasses import dataclass
from typing import Iterable

from symmetry_tpu_torch.analysis.core import (
    CheckerSpec,
    Finding,
    Project,
    SourceFile,
)
from symmetry_tpu_torch.analysis.dataflow import (
    analyze,
    assigned_paths,
    dotted_path,
    iter_functions,
    walk_scope,
)

NAME = "lifecycle"

# Production code only: tests acquire handles to assert ON them (a
# fixture that deliberately leaks is the checker's own test data), and
# tools are one-shot processes whose exit releases everything.
GROUP = ("symmetry_tpu_torch/*.py",)


@dataclass(frozen=True)
class ReleaseSpec:
    """One way to release a handle. mode "method": `h.m()` releases h.
    mode "arg": `anything.m(h)` releases h (the pool's `unref(ids)`
    shape, where the handle is the id list, not the receiver)."""

    methods: frozenset[str]
    mode: str = "method"
    idempotent: bool = True


@dataclass(frozen=True)
class ResourceSpec:
    """One paired-resource protocol, matched structurally by method
    name (no type inference): `kind` "result" tracks the acquire
    call's assigned result as the handle, "receiver" tracks the
    callee's receiver (`lock.acquire()` pins `lock` itself).
    `receiver_hint`, when set, requires the acquire receiver's last
    dotted segment to CONTAIN it (case-insensitive) — what keeps
    `pool.alloc` from matching every `.alloc` in sight."""

    name: str
    acquire: frozenset[str]
    releases: tuple[ReleaseSpec, ...]
    kind: str = "result"
    receiver_hint: str | None = None
    optional: bool = False          # acquire may return None (a miss)


SPECS: tuple[ResourceSpec, ...] = (
    ResourceSpec(
        name="radix-hit",
        acquire=frozenset({"lookup"}),
        optional=True,
        releases=(ReleaseSpec(frozenset({"release"}), idempotent=True),),
    ),
    ResourceSpec(
        name="insert-plan",
        acquire=frozenset({"plan_insert"}),
        optional=True,
        releases=(
            ReleaseSpec(frozenset({"commit"}), idempotent=False),
            ReleaseSpec(frozenset({"abort"}), idempotent=True),
        ),
    ),
    ResourceSpec(
        name="pool-blocks",
        acquire=frozenset({"alloc"}),
        receiver_hint="pool",
        optional=True,
        releases=(
            ReleaseSpec(frozenset({"unref", "free"}), mode="arg",
                        idempotent=False),
        ),
    ),
    ResourceSpec(
        name="lock",
        acquire=frozenset({"acquire"}),
        kind="receiver",
        receiver_hint="lock",
        releases=(ReleaseSpec(frozenset({"release"}), idempotent=False),),
    ),
    ResourceSpec(
        # The per-stream resume journal entry (provider/backends/base.py
        # ResumeJournal): track() on admission, release() on EVERY exit
        # path — exception edges included. A leaked entry is a finished
        # request the death path would stamp `emitted` for forever (and
        # an unbounded dict on a busy provider); an early release is a
        # crash shed that stamps 0 and costs the client its RNG-lane
        # anchor.
        name="resume-journal",
        acquire=frozenset({"track"}),
        receiver_hint="journal",
        releases=(ReleaseSpec(frozenset({"release"}), idempotent=True),),
    ),
    ResourceSpec(
        # The symledger cost account (engine/ledger.py): track() opens
        # a request's entry (None while tpu.ledger is off), finish()
        # builds its wire costs block, release() folds a handoff
        # without one — both idempotent, so every exit path may close
        # unconditionally. A leaked entry is a request whose device
        # seconds never fold into the aggregates: conservation silently
        # stops closing. The receiver hint keeps this spec off the
        # resume journal's same-named `track`.
        name="ledger-entry",
        acquire=frozenset({"track"}),
        receiver_hint="ledger",
        optional=True,
        releases=(ReleaseSpec(frozenset({"finish", "release"}),
                              idempotent=True),),
    ),
)

_ALL_ACQUIRES = frozenset().union(*(s.acquire for s in SPECS))

# Handle statuses. HELD: definitely pinned. OPT: pinned-or-None (an
# optional acquire nobody narrowed yet). RELEASED: resolved — further
# non-idempotent releases are L403, other reads L404.
_HELD, _OPT, _REL = "H", "O", "R"


@dataclass(frozen=True)
class _Handle:
    var: str            # dotted path holding the handle
    spec: int           # index into SPECS
    line: int           # acquire site (leak findings anchor here)
    status: str

    def at(self, status: str) -> "_Handle":
        return _Handle(self.var, self.spec, self.line, status)


# Abstract state: a sorted tuple of handles (hashable; the dataflow
# engine keeps distinct states distinct per path until they converge).
_State = tuple[_Handle, ...]


def _with(state: _State, *handles: _Handle) -> _State:
    keep = [h for h in state if all(h.var != n.var for n in handles)]
    return tuple(sorted(keep + list(handles),
                        key=lambda h: (h.var, h.line, h.spec)))


def _without(state: _State, *vars_: str) -> _State:
    return tuple(h for h in state if h.var not in vars_)


def _call_parts(call: ast.Call) -> tuple[str | None, str | None]:
    """(receiver dotted path, method name) of a call. A bare-name call
    (`lookup(ids)` through a bound-method variable) has no receiver
    but still a matchable trailing name."""
    f = call.func
    if isinstance(f, ast.Attribute):
        return dotted_path(f.value), f.attr
    if isinstance(f, ast.Name):
        return None, f.id
    return None, None


def _maximal_paths(expr: ast.AST) -> list[str]:
    """Dotted paths of the MAXIMAL Name/Attribute chains in `expr`:
    `(hit, [t])` yields "hit" but `hit.length` yields only
    "hit.length" — returning a handle's attribute is a read of the
    handle, not a transfer of it."""
    out: list[str] = []

    def visit(n: ast.AST) -> None:
        if isinstance(n, (ast.Attribute, ast.Name)):
            p = dotted_path(n)
            if p is not None:
                out.append(p)
                return  # inner names are chain segments, not refs
        for c in ast.iter_child_nodes(n):
            visit(c)

    visit(expr)
    return out


def _receiver_ok(spec: ResourceSpec, recv: str | None) -> bool:
    if spec.receiver_hint is None:
        return True
    if recv is None:
        return False
    return spec.receiver_hint in recv.split(".")[-1].lower()


def _acquire_spec(call: ast.Call) -> int | None:
    recv, meth = _call_parts(call)
    if meth is None or meth not in _ALL_ACQUIRES:
        return None
    for i, spec in enumerate(SPECS):
        if meth in spec.acquire and _receiver_ok(spec, recv):
            return i
    return None


class _Semantics:
    """Dataflow semantics for one function. Findings are (code, line,
    var, acq_line, message) tuples; the checker maps them to Finding
    objects afterwards."""

    def __init__(self) -> None:
        # Per-CFG-node syntactic facts, computed once — the walker
        # re-enters transfer() for every abstract state that reaches a
        # node, and the AST scans depend only on the node.
        self._facts_cache: dict[int, tuple] = {}

    def initial(self) -> _State:
        return ()

    # ------------------------------------------------------------ facts

    def _facts(self, node, expr):
        """(calls, loads, yield_paths, walrus) for one CFG node.
        calls: (call, recv, meth, arg_paths, arg_ids) per same-scope
        Call; loads: (sub, path) per Name/Attribute Load; yield_paths:
        maximal paths yielded; walrus: (name, spec_i, lineno) per
        `(h := acquire())`. Nested def/lambda bodies are skipped —
        deferred code does not execute at this statement."""
        cached = self._facts_cache.get(id(node))
        if cached is not None:
            return cached
        calls: list[tuple] = []
        loads: list[tuple] = []
        yield_paths: set[str] = set()
        walrus: list[tuple] = []
        for sub in walk_scope(expr):
            if isinstance(sub, ast.Call):
                recv, meth = _call_parts(sub)
                args = list(sub.args) + [kw.value for kw in sub.keywords]
                calls.append((sub, recv, meth,
                              tuple(dotted_path(a) for a in args),
                              frozenset(id(a) for a in args)))
            elif isinstance(sub, (ast.Name, ast.Attribute)):
                if isinstance(getattr(sub, "ctx", None), ast.Load):
                    p = dotted_path(sub)
                    if p is not None:
                        loads.append((sub, p))
            elif isinstance(sub, (ast.Yield, ast.YieldFrom)):
                if sub.value is not None:
                    yield_paths.update(_maximal_paths(sub.value))
            elif isinstance(sub, ast.NamedExpr):
                if isinstance(sub.target, ast.Name) \
                        and isinstance(sub.value, ast.Call):
                    i = _acquire_spec(sub.value)
                    if i is not None:
                        walrus.append((sub.target.id, i,
                                       sub.value.func.lineno))
        facts = (calls, loads, frozenset(yield_paths), tuple(walrus))
        self._facts_cache[id(node)] = facts
        return facts

    # ------------------------------------------------------------ transfer

    def transfer(self, node, state: _State):
        stmt = node.stmt
        expr = node.expr if node.expr is not None else stmt
        if isinstance(stmt, ast.ExceptHandler):
            # The handler NODE is just the catch point — its body is
            # sequenced as separate nodes; walking it here would apply
            # every effect twice.
            expr = None
        findings: list[tuple] = []
        post = state
        releases: list[_Handle] = []

        calls, loads, yield_paths, walrus = self._facts(node, expr)

        # 1. Releases (before use-checking: the release call's own read
        #    of the handle is not a use-after-release).
        released_vars: set[str] = set()
        for call, recv, meth, arg_paths, _aids in calls:
            for h in post:
                spec = SPECS[h.spec]
                for rel in spec.releases:
                    if meth not in rel.methods:
                        continue
                    hit = (rel.mode == "method" and recv == h.var) or \
                          (rel.mode == "arg" and h.var in arg_paths)
                    if not hit:
                        continue
                    if h.status == _REL and not rel.idempotent:
                        findings.append((
                            "L403", call.func.lineno, h.var, h.line,
                            f"double release of {spec.name} handle "
                            f"`{h.var}` (acquired line {h.line}): "
                            f"`{meth}()` is not idempotent — on the "
                            f"path where it already resolved, this "
                            f"raises or double-frees"))
                    releases.append(h.at(_REL))
                    released_vars.add(h.var)
        if releases:
            post = _with(post, *releases)

        # 2. Use-after-release: a read INTO a released handle (its
        #    attributes — `plan.new_ids` after abort is freed block
        #    ids) or passing it onward to a call. A bare reference is
        #    NOT a use: `if hit is not None: hit.release()` in a
        #    cleanup handler reads the name, never the resource.
        arg_ids = frozenset().union(*(aids for *_rest, aids in calls)) \
            if calls else frozenset()
        for h in post:
            if h.status != _REL or h.var in released_vars:
                continue
            for sub, p in loads:
                deeper = p.startswith(h.var + ".")
                passed = p == h.var and id(sub) in arg_ids
                if deeper or passed:
                    spec = SPECS[h.spec]
                    findings.append((
                        "L404", sub.lineno, h.var, h.line,
                        f"use of {spec.name} handle `{h.var}` after "
                        f"release (acquired line {h.line}, resolved "
                        f"on this path) — its blocks may already be "
                        f"reused"))
                    break

        # 3. Ownership transfer: the handle ITSELF escapes — returned,
        #    yielded, stored into something, or passed to a call that
        #    is not one of its releases. Tracking ends, no finding.
        escaped: set[str] = set()
        held_vars = {h.var for h in post if h.status in (_HELD, _OPT)}
        if held_vars:
            # Only a MAXIMAL reference transfers ownership: `return
            # hit` escapes, `return hit.length` merely reads the pin
            # and must keep it tracked (and leaking).
            if isinstance(stmt, ast.Return) and stmt.value is not None:
                escaped |= held_vars & set(_maximal_paths(stmt.value))
            escaped |= held_vars & yield_paths
            for _call, _recv, _meth, arg_paths, _aids in calls:
                for p in arg_paths:
                    if p in held_vars and p not in released_vars:
                        escaped.add(p)
            if isinstance(stmt, ast.Assign):
                # `self.hit = h` / `units[k] = (h, reqs)` hands
                # ownership off — the handle escapes even when packed
                # inside a tuple/list on the way into the container.
                # A plain local target transfers too: `pair = (hit, t)`
                # then `return pair` is ordinary code, and once the
                # handle lives under another name this intraprocedural
                # walk cannot follow it — alias, not a leak. (The
                # acquire statement itself never matches: its value's
                # maximal paths are the callee chain and arguments, not
                # the fresh handle.)
                escaped |= held_vars & set(_maximal_paths(stmt.value))
        if escaped:
            post = _without(post, *escaped)

        # 4. Rebinds: assigning over a variable drops its old handle.
        #    Overwriting a definitely-HELD handle is itself a leak.
        rebound = assigned_paths(stmt) if stmt is not None else set()
        acq: list[_Handle] = []
        # Only a LOCAL name binds a tracked handle: `self.hit =
        # idx.lookup(t)` stores ownership somewhere that outlives this
        # function — that is a transfer, not an acquisition to audit.
        if isinstance(stmt, ast.Assign) and len(stmt.targets) == 1 \
                and isinstance(stmt.targets[0], ast.Name):
            tgt = dotted_path(stmt.targets[0])
            if tgt is not None:
                spec_i, opt = self._acquire_of(stmt.value)
                if spec_i is not None:
                    status = _OPT if (opt or SPECS[spec_i].optional) \
                        else _HELD
                    acq.append(_Handle(tgt, spec_i, stmt.lineno, status))
        # Walrus acquires — `if (hit := idx.lookup(t)) is not None:` —
        # bind a tracked handle exactly like a plain assignment.
        for name, spec_i, lineno in walrus:
            status = _OPT if SPECS[spec_i].optional else _HELD
            acq.append(_Handle(name, spec_i, lineno, status))
        if rebound:
            acq_vars = {h.var for h in acq}
            for h in post:
                for rb in rebound:
                    if h.var != rb and not h.var.startswith(rb + "."):
                        continue
                    if h.status == _HELD and h.var not in acq_vars:
                        findings.append((
                            "L401", stmt.lineno, h.var, h.line,
                            f"{SPECS[h.spec].name} handle `{h.var}` "
                            f"(acquired line {h.line}) overwritten "
                            f"while still held — the pin leaks"))
            post = tuple(h for h in post
                         if not any(h.var == rb
                                    or h.var.startswith(rb + ".")
                                    for rb in rebound))

        # 5. Acquires. A result-kind acquire whose value is dropped
        #    (bare expression statement) leaks immediately.
        exc_base = _with(state, *releases) if releases else state
        if acq:
            post = _with(post, *acq)
        for call, recv, meth, _apaths, _aids in calls:
            spec_i = _acquire_spec(call)
            if spec_i is None:
                continue
            spec = SPECS[spec_i]
            if spec.kind == "receiver":
                if recv is not None:
                    h = _Handle(recv, spec_i, call.func.lineno, _HELD)
                    post = _with(post, h)
            elif not self._call_is_consumed(call, stmt):
                findings.append((
                    "L401", call.func.lineno, meth or "?",
                    call.func.lineno,
                    f"{spec.name} acquire result discarded — the "
                    f"pinned handle can never be released"))

        # Exception edge: the statement's effects may not have happened
        # (an acquire that raised acquired nothing), but releases
        # stick — a release that raises still released — and so do
        # escapes: arguments are evaluated before the call body runs,
        # so a callee that raises already received the handle and owns
        # its cleanup.
        if escaped:
            exc_base = _without(exc_base, *escaped)
        return post, exc_base, findings

    @staticmethod
    def _acquire_of(value: ast.AST) -> tuple[int | None, bool]:
        """(spec index, forced-optional) when `value` is an acquire
        call, possibly behind a conditional expression (`x if c else
        None` — the advance_chunked_prefill idiom)."""
        if isinstance(value, ast.Call):
            return _acquire_spec(value), False
        if isinstance(value, ast.IfExp):
            for arm in (value.body, value.orelse):
                if isinstance(arm, ast.Call):
                    i = _acquire_spec(arm)
                    if i is not None:
                        return i, True
        return None, False

    @staticmethod
    def _call_is_consumed(call: ast.Call, stmt) -> bool:
        """True when the acquire call's result is bound, returned, or
        otherwise fed into the surrounding expression — only a bare
        `idx.lookup(x)` statement discards the pin outright."""
        return not (isinstance(stmt, ast.Expr) and stmt.value is call)

    # ------------------------------------------------------------ branches

    def on_branch(self, test, state: _State, taken: bool):
        if test is None:
            return state
        if isinstance(test, ast.BoolOp) and isinstance(test.op, ast.And):
            if not taken:
                return state  # any conjunct may have failed: no narrowing
            # All conjuncts held: narrow through each in turn (`ids is
            # None and self._evict_one()` — on the true branch, ids IS
            # None and its handle is gone before the eviction call runs).
            for part in test.values:
                state = self.on_branch(part, state, True)
                if state is None:
                    return None
            return state
        var, none_when_true = self._none_test(test)
        if var is None:
            return state
        for h in state:
            if h.var != var:
                continue
            is_none_branch = (taken == none_when_true)
            if h.status == _OPT:
                return _without(state, var) if is_none_branch \
                    else _with(state, h.at(_HELD))
            if h.status == _HELD and is_none_branch:
                return None  # held handles are not None: path infeasible
        return state

    @staticmethod
    def _none_test(test) -> tuple[str | None, bool]:
        """(var, none_when_true) for the narrowable shapes: `x is
        None`, `x is not None`, bare `x`, `not x`."""
        if isinstance(test, ast.NamedExpr):
            # `if (hit := idx.lookup(t)):` — the walrus target carries
            # the handle the branch narrows.
            test = test.target
        if isinstance(test, ast.Compare) and len(test.ops) == 1 \
                and isinstance(test.comparators[0], ast.Constant) \
                and test.comparators[0].value is None:
            left = test.left
            if isinstance(left, ast.NamedExpr):
                left = left.target
            var = dotted_path(left)
            if isinstance(test.ops[0], ast.Is):
                return var, True
            if isinstance(test.ops[0], ast.IsNot):
                return var, False
            return None, False
        if isinstance(test, ast.UnaryOp) and isinstance(test.op, ast.Not):
            var, nwt = _Semantics._none_test(test.operand)
            return (var, not nwt) if var is not None else (None, False)
        var = dotted_path(test)
        if var is not None:
            return var, False  # truthy handle == held
        return None, False

    # ---------------------------------------------------------------- exit

    def at_exit(self, state: _State, exceptional: bool):
        findings = []
        for h in state:
            if h.status == _REL:
                continue
            spec = SPECS[h.spec]
            code = "L402" if exceptional else "L401"
            maybe = "may leak" if h.status == _OPT else "leaks"
            how = ("an exception path unwinds past the pin"
                   if exceptional else "the function exits without "
                   "releasing it")
            rels = sorted(m for r in spec.releases for m in r.methods)
            findings.append((
                code, h.line, h.var, h.line,
                f"{spec.name} handle `{h.var}` (acquired line {h.line}) "
                f"{maybe}: {how} — call {' / '.join(rels)} on every "
                f"path, exception edges included"))
        return findings


def _function_acquires(func) -> bool:
    for node in ast.walk(func):
        if isinstance(node, ast.Call):
            _, meth = _call_parts(node)
            if meth in _ALL_ACQUIRES:
                return True
    return False


def _check_file(sf: SourceFile) -> Iterable[Finding]:
    for func in iter_functions(sf.tree):
        if not _function_acquires(func):
            continue
        sem = _Semantics()
        for code, line, var, acq_line, message in analyze(func, sem):
            del acq_line  # in the message; fingerprints stay line-free
            yield Finding(
                checker=NAME, code=code, path=sf.rel, line=line,
                symbol=f"{func.name}:{var}",
                message=f"{message} [in {func.name}()]")


def check(project: Project) -> list[Finding]:
    findings: list[Finding] = []
    for sf in project.select(GROUP):
        findings.extend(_check_file(sf))
    return findings


SPEC = CheckerSpec(
    name=NAME,
    doc="paired-resource lifecycle (pins/plans/locks) on every path",
    run=check,
    codes=("L401", "L402", "L403", "L404"),
)
