"""Donation checker: donated jit buffers must not be read again.

`jax.jit(..., donate_argnums=...)` lets XLA reuse an input buffer for
the output — the engine's whole steady-state decode loop depends on it
(the KV cache would otherwise double in HBM every step). The failure
mode is silent: on TPU a donated array is not poisoned, it ALIASES the
output, so reading it after the call returns whatever the kernel wrote
there — garbage tokens, not an exception. (CPU jax warns; the chip
does not.) The discipline is purely syntactic — every donated argument
must be REBOUND from the call's return before the next read — so it is
statically checkable, and path-sensitively so: the bug is reading the
stale name on one path (a retry arm, an exception handler) while the
happy path rebinds it.

Resolution: donation sites are found per file — `self._f = jax.jit(fn,
donate_argnums=(k,))` (the engine's build() idiom, including the
mesh/no-mesh double registration) and `@functools.partial(jax.jit,
donate_argnums=(k,))` decorators. Every call through the registered
name is then walked with the dataflow engine:

  D501  a donated argument is read after the jitted call on some path
        without being rebound — use-after-donation aliasing
  D502  the jitted call's result is discarded (bare expression
        statement): the donated buffer was invalidated and the only
        copy of its replacement dropped

Rebinding any prefix clears the poison (`job.cache = None` poisons
nothing and clears `job.cache`; `self.state = self._decode(...,
self.state, ...)` in one statement is the idiom and never flags).

Pure stdlib, no JAX import — the CI gate runs before `pip install`.
"""

from __future__ import annotations

import ast
from typing import Iterable

from symmetry_tpu_torch.analysis.core import (
    CheckerSpec,
    Finding,
    Project,
    SourceFile,
)
from symmetry_tpu_torch.analysis.dataflow import (
    analyze,
    dotted_path,
    iter_functions,
    walk_scope,
)

NAME = "donation"

# Wherever jits are built: the engine package and ops/models (decorator
# style). Tests/tools don't donate.
GROUP = ("symmetry_tpu_torch/*.py",)


def _donate_positions(call: ast.Call) -> tuple[int, ...] | None:
    """The constant donate_argnums of a jax.jit(...) call, else None
    (no donation, or not resolvable statically)."""
    for kw in call.keywords:
        if kw.arg != "donate_argnums":
            continue
        v = kw.value
        if isinstance(v, ast.Constant) and isinstance(v.value, int):
            return (v.value,)
        if isinstance(v, (ast.Tuple, ast.List)):
            out = []
            for e in v.elts:
                if not (isinstance(e, ast.Constant)
                        and isinstance(e.value, int)):
                    return None
                out.append(e.value)
            return tuple(out)
        return None
    return None


def _is_jit(func: ast.AST) -> bool:
    p = dotted_path(func)
    return p is not None and p.split(".")[-1] == "jit"


def donation_registry(tree: ast.Module) -> dict[str, tuple[int, ...]]:
    """Donated-callable names for one file: dotted assignment target of
    `<t> = jax.jit(fn, donate_argnums=...)`, or the name of a def
    decorated `@partial(jax.jit, donate_argnums=...)`. Re-registration
    (the engine's mesh/no-mesh arms) unions positions — conservative
    either way."""
    reg: dict[str, tuple[int, ...]] = {}

    def add(name: str, pos: tuple[int, ...]) -> None:
        reg[name] = tuple(sorted(set(reg.get(name, ()) + pos)))

    for node in ast.walk(tree):
        if isinstance(node, ast.Assign) and isinstance(node.value, ast.Call):
            call = node.value
            if _is_jit(call.func):
                pos = _donate_positions(call)
                if pos:
                    for t in node.targets:
                        p = dotted_path(t)
                        if p is not None:
                            add(p, pos)
        elif isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            for dec in node.decorator_list:
                if not isinstance(dec, ast.Call):
                    continue
                head = dotted_path(dec.func)
                if head is None or head.split(".")[-1] != "partial":
                    continue
                if not (dec.args and _is_jit(dec.args[0])):
                    continue
                pos = _donate_positions(dec)
                if pos:
                    add(node.name, pos)
    return reg


# Abstract state: sorted tuple of (poisoned path, donation line).
_State = tuple[tuple[str, int], ...]


class _Semantics:
    def __init__(self, registry: dict[str, tuple[int, ...]]) -> None:
        self.registry = registry

    def initial(self) -> _State:
        return ()

    def _donated_call(self, call: ast.Call) -> tuple[int, ...] | None:
        p = dotted_path(call.func)
        if p is None:
            return None
        return self.registry.get(p)

    def transfer(self, node, state: _State):
        stmt = node.stmt
        expr = node.expr if node.expr is not None else stmt
        if isinstance(stmt, ast.ExceptHandler):
            expr = None  # body statements are their own nodes
        findings: list[tuple] = []
        post = list(state)

        # walk_scope, not ast.walk: a lambda/nested-def body is deferred
        # code — it does not execute (or read anything) at this
        # statement, and by the time a scheduled callback runs the happy
        # path has usually rebound the name.
        calls = [n for n in walk_scope(expr) if isinstance(n, ast.Call)] \
            if expr is not None else []
        donated_here: list[tuple[str, ast.Call]] = []
        for call in calls:
            pos = self._donated_call(call)
            if pos is None:
                continue
            for k in pos:
                if k < len(call.args) and not isinstance(
                        call.args[k], ast.Starred):
                    p = dotted_path(call.args[k])
                    if p is not None:
                        donated_here.append((p, call))
            if isinstance(stmt, ast.Expr) and stmt.value is call:
                findings.append((
                    "D502", call.func.lineno,
                    dotted_path(call.func) or "?",
                    f"result of donated-jit call "
                    f"`{dotted_path(call.func)}` discarded — the "
                    f"donated buffer was invalidated and its "
                    f"replacement dropped; bind the return value"))

        # 1. Reads of already-poisoned paths (the donated args read BY
        #    this statement's own call were read before dispatch — they
        #    are poisoned only AFTER; same-statement reads are fine).
        if expr is not None and post:
            for sub in walk_scope(expr):
                if not isinstance(sub, (ast.Name, ast.Attribute)):
                    continue
                if not isinstance(getattr(sub, "ctx", None), ast.Load):
                    continue
                p = dotted_path(sub)
                if p is None:
                    continue
                for path, dline in post:
                    if p == path or p.startswith(path + "."):
                        findings.append((
                            "D501", sub.lineno, path,
                            f"`{p}` read here, but `{path}` was donated "
                            f"to a jitted call on line {dline} and never "
                            f"rebound — on TPU it aliases the call's "
                            f"OUTPUT buffer now (silent garbage, not an "
                            f"error)"))
                        break

        # 1b. An augmented assignment's target is an implicit LOAD the
        #     ctx-based scan above cannot see (`self.state += d` reads
        #     the donated buffer to compute the new value) — flag it
        #     before step 2 clears the poison for the store half.
        if isinstance(stmt, ast.AugAssign) and post:
            p = dotted_path(stmt.target)
            if p is not None:
                for path, dline in post:
                    if p == path or p.startswith(path + "."):
                        findings.append((
                            "D501", stmt.lineno, path,
                            f"`{p}` augmented-assigned here, but `{path}` "
                            f"was donated to a jitted call on line {dline} "
                            f"and never rebound — the read half aliases "
                            f"the call's OUTPUT buffer (silent garbage, "
                            f"not an error)"))
                        break

        # 2. Rebinds clear poison — assigning a path clears it and
        #    everything under it; assigning `job` clears `job.cache`.
        targets: list[str] = []
        if isinstance(stmt, ast.Assign):
            for t in stmt.targets:
                targets.extend(_target_paths(t))
        elif isinstance(stmt, (ast.AnnAssign, ast.AugAssign)):
            targets.extend(_target_paths(stmt.target))
        elif isinstance(stmt, (ast.For, ast.AsyncFor)) \
                and node.expr is getattr(stmt, "iter", None):
            targets.extend(_target_paths(stmt.target))
        elif isinstance(stmt, ast.Delete):
            for t in stmt.targets:
                targets.extend(_target_paths(t))
        if targets:
            # Assigning a path (or a prefix of it) clears the poison;
            # assigning INTO the donated object (`job.cache.k = v`) is
            # itself a read of the stale buffer and stays poisoned —
            # step 1 already flagged the implicit load.
            post = [(p, ln) for p, ln in post
                    if not any(p == t or p.startswith(t + ".")
                               for t in targets)]

        # 3. This statement's donations take effect AFTER its reads —
        #    unless the same statement rebinds the path (the
        #    `state = f(state)` idiom).
        for p, call in donated_here:
            if any(p == t or t.startswith(p + ".")
                   or p.startswith(t + ".") for t in targets):
                continue
            if all(p != q for q, _ in post):
                post.append((p, call.func.lineno))

        post_t = tuple(sorted(post))
        # Donation happens at dispatch: poison survives the exception
        # edge too (the call raised AFTER invalidating the buffer is
        # the conservative read).
        return post_t, post_t, findings

    def on_branch(self, test, state: _State, taken: bool):
        return state

    def at_exit(self, state: _State, exceptional: bool):
        return ()  # a poisoned local dying at exit is fine


def _target_paths(t: ast.AST) -> list[str]:
    if isinstance(t, (ast.Tuple, ast.List)):
        out: list[str] = []
        for e in t.elts:
            out.extend(_target_paths(e))
        return out
    if isinstance(t, ast.Starred):
        return _target_paths(t.value)
    p = dotted_path(t)
    return [p] if p is not None else []


def _check_file(sf: SourceFile) -> Iterable[Finding]:
    registry = donation_registry(sf.tree)
    if not registry:
        return
    names = {n.split(".")[-1] for n in registry}
    for func in iter_functions(sf.tree):
        if not any(isinstance(n, ast.Call)
                   and (dp := dotted_path(n.func)) is not None
                   and dp.split(".")[-1] in names
                   for n in ast.walk(func)):
            continue
        sem = _Semantics(registry)
        for code, line, symbol, message in analyze(func, sem):
            yield Finding(
                checker=NAME, code=code, path=sf.rel, line=line,
                symbol=f"{func.name}:{symbol}",
                message=f"{message} [in {func.name}()]")


def check(project: Project) -> list[Finding]:
    findings: list[Finding] = []
    for sf in project.select(GROUP):
        findings.extend(_check_file(sf))
    return findings


SPEC = CheckerSpec(
    name=NAME,
    doc="donate_argnums buffers never read after the jitted call",
    run=check,
    codes=("D501", "D502"),
)
