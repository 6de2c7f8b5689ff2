"""Intraprocedural CFG + path-sensitive forward dataflow engine.

PR 12's review found a crash none of the flat AST checkers could see:
`plan_insert` triggered an eviction that freed the blocks its own
matched prefix was about to extend — a *path*-sensitive bug in the
acquire/pin/free discipline the paged KV pool makes load-bearing. The
flat checkers pattern-match single statements; this module gives the
suite the machinery to reason about *orderings*: which statements can
execute before which, on which paths, including the paths only an
exception takes.

Two pieces:

  - `build_cfg(func)`: a control-flow graph over one function's AST.
    One node per executed statement part (an `if`'s node is its test,
    a `for`'s its iterator), edges labeled normal / true-branch /
    false-branch / exception. `try/except/finally` is modeled
    faithfully: every statement that can raise gets an edge to the
    innermost handler set (and past it, when no handler is a
    catch-all), and `finally` bodies are CLONED per continuation kind
    (fallthrough, exception, return, break, continue) so the analysis
    sees the release-in-finally that makes a leaky-looking path safe.
    `return`/`raise`/`break`/`continue` edges leave their block early;
    the function has one normal exit and one exceptional exit.

  - `analyze(func, semantics)`: a forward walker that pushes abstract
    states through the CFG to a bounded fixpoint. States are opaque
    hashable values owned by the checker's `semantics` object; the
    engine only joins them as SETS (per-path states are kept distinct
    until they converge — that is the path-sensitivity), prunes
    branches the semantics declares infeasible (`if x is None` on a
    state that knows x is held), and reports exit states.

Checkers plug in via the `Semantics` duck type:

    initial() -> state
    transfer(node, state) -> (post_state, exc_state, findings)
        `exc_state` is what propagates along this node's exception
        edge — usually the PRE state (the statement's effects may not
        have happened), but release-like effects should stick (a
        release that raises still released).
    on_branch(test, state, taken: bool) -> state | None
        None = branch infeasible under this state (pruned).
    at_exit(state, exceptional: bool) -> findings

Findings are checker-defined hashables (dedup'd across paths by the
engine). The walker is bounded (`max_states_per_node`, `max_steps`)
so pathological functions degrade to partial coverage, never hangs —
the CI gate's whole value is running in seconds.

Pure stdlib, no JAX import (the CI gate runs before `pip install`).
"""

from __future__ import annotations

import ast
from collections import deque
from typing import Any, Iterable, Iterator

from symmetry_tpu_torch.analysis.core import dotted_name

EDGE_NORMAL = "n"
EDGE_TRUE = "t"
EDGE_FALSE = "f"
EDGE_EXC = "e"

# Exceptions a handler with one of these names catches "everything"
# for our purposes: no propagate-past-handlers edge is added.
_CATCH_ALL_NAMES = {"Exception", "BaseException"}


class Node:
    """One CFG node. `stmt` is the governing AST statement (None for
    synthetic join/entry/exit nodes), `expr` the fragment actually
    evaluated AT this node (an `if` node evaluates only its test),
    `test` the branch condition when outgoing t/f edges exist."""

    __slots__ = ("stmt", "expr", "test", "label", "succs")

    def __init__(self, stmt: ast.AST | None = None,
                 expr: ast.AST | None = None,
                 test: ast.AST | None = None, label: str = "") -> None:
        self.stmt = stmt
        self.expr = expr
        self.test = test
        self.label = label
        self.succs: list[tuple["Node", str]] = []

    def edge(self, other: "Node", kind: str = EDGE_NORMAL) -> None:
        pair = (other, kind)
        if pair not in self.succs:
            self.succs.append(pair)

    def __repr__(self) -> str:  # pragma: no cover - debugging aid
        what = self.label or type(self.stmt).__name__
        line = getattr(self.stmt, "lineno", "?")
        return f"<Node {what}@{line} ->{len(self.succs)}>"


class CFG:
    def __init__(self, entry: Node, exit_: Node, exc_exit: Node) -> None:
        self.entry = entry
        self.exit = exit_
        self.exc_exit = exc_exit
        self.nodes: list[Node] = []


def can_raise(node: ast.AST | None) -> bool:
    """Conservative: an expression that calls, subscripts (a Load —
    KeyError/IndexError are routine; a Store into a dict cannot
    realistically fail), awaits, raises or asserts can raise. Plain
    name/constant shuffling cannot (close enough — attribute access on
    project dataclasses does not realistically fail, and treating it
    as raising would fabricate an exception path out of every
    statement). Nested def/lambda bodies are deferred code — a `def`
    whose body calls cannot raise at the definition statement."""
    if node is None:
        return False
    for sub in walk_scope(node):
        if isinstance(sub, (ast.Call, ast.Raise, ast.Assert, ast.Await,
                            ast.Yield, ast.YieldFrom)):
            return True
        if isinstance(sub, ast.Subscript) and not isinstance(
                sub.ctx, ast.Store):
            return True
    return False


class _Ctx:
    """Where non-local control transfers land from the current point:
    raising statements (`exc`), `return` (`ret`), `break`/`continue`
    (`brk`/`cont`, None outside loops)."""

    __slots__ = ("exc", "ret", "brk", "cont")

    def __init__(self, exc: Node, ret: Node,
                 brk: Node | None = None, cont: Node | None = None) -> None:
        self.exc = exc
        self.ret = ret
        self.brk = brk
        self.cont = cont

    def replace(self, **kw: Any) -> "_Ctx":
        vals = {s: getattr(self, s) for s in self.__slots__}
        vals.update(kw)
        return _Ctx(**vals)


# A "frontier" is the set of dangling (node, edge_kind) pairs whose
# next normal successor is whatever statement comes next.
_Frontier = list[tuple[Node, str]]


class _Builder:
    def __init__(self) -> None:
        self.nodes: list[Node] = []

    def new(self, **kw: Any) -> Node:
        node = Node(**kw)
        self.nodes.append(node)
        return node

    def _connect(self, preds: _Frontier, node: Node) -> None:
        for p, kind in preds:
            p.edge(node, kind)

    def seq(self, stmts: Iterable[ast.stmt], preds: _Frontier,
            ctx: _Ctx) -> _Frontier:
        for s in stmts:
            preds = self.stmt(s, preds, ctx)
        return preds

    # ------------------------------------------------------------ statements

    def stmt(self, s: ast.stmt, preds: _Frontier, ctx: _Ctx) -> _Frontier:
        if isinstance(s, ast.If):
            return self._if(s, preds, ctx)
        if isinstance(s, (ast.While,)):
            return self._while(s, preds, ctx)
        if isinstance(s, (ast.For, ast.AsyncFor)):
            return self._for(s, preds, ctx)
        if isinstance(s, ast.Try) or s.__class__.__name__ == "TryStar":
            return self._try(s, preds, ctx)
        if isinstance(s, (ast.With, ast.AsyncWith)):
            return self._with(s, preds, ctx)
        if isinstance(s, ast.Return):
            node = self.new(stmt=s, expr=s.value)
            self._connect(preds, node)
            if can_raise(s.value):
                node.edge(ctx.exc, EDGE_EXC)
            node.edge(ctx.ret, EDGE_NORMAL)
            return []
        if isinstance(s, ast.Raise):
            node = self.new(stmt=s, expr=s)
            self._connect(preds, node)
            node.edge(ctx.exc, EDGE_EXC)
            return []
        if isinstance(s, ast.Break):
            node = self.new(stmt=s)
            self._connect(preds, node)
            node.edge(ctx.brk if ctx.brk is not None else ctx.ret,
                      EDGE_NORMAL)
            return []
        if isinstance(s, ast.Continue):
            node = self.new(stmt=s)
            self._connect(preds, node)
            node.edge(ctx.cont if ctx.cont is not None else ctx.ret,
                      EDGE_NORMAL)
            return []
        # Plain statement (assignment, expression, def, pass, ...).
        node = self.new(stmt=s, expr=s)
        self._connect(preds, node)
        if can_raise(s):
            node.edge(ctx.exc, EDGE_EXC)
        return [(node, EDGE_NORMAL)]

    def _if(self, s: ast.If, preds: _Frontier, ctx: _Ctx) -> _Frontier:
        node = self.new(stmt=s, expr=s.test, test=s.test)
        self._connect(preds, node)
        if can_raise(s.test):
            node.edge(ctx.exc, EDGE_EXC)
        out = self.seq(s.body, [(node, EDGE_TRUE)], ctx)
        if s.orelse:
            out += self.seq(s.orelse, [(node, EDGE_FALSE)], ctx)
        else:
            out.append((node, EDGE_FALSE))
        return out

    def _while(self, s: ast.While, preds: _Frontier, ctx: _Ctx) -> _Frontier:
        head = self.new(stmt=s, expr=s.test, test=s.test)
        self._connect(preds, head)
        if can_raise(s.test):
            head.edge(ctx.exc, EDGE_EXC)
        join = self.new(label="loop-exit")
        body_ctx = ctx.replace(brk=join, cont=head)
        body_out = self.seq(s.body, [(head, EDGE_TRUE)], body_ctx)
        self._connect(body_out, head)
        exit_preds: _Frontier = [(head, EDGE_FALSE)]
        if s.orelse:
            exit_preds = self.seq(s.orelse, exit_preds, ctx)
        self._connect(exit_preds, join)
        return [(join, EDGE_NORMAL)]

    def _for(self, s: ast.For | ast.AsyncFor, preds: _Frontier,
             ctx: _Ctx) -> _Frontier:
        head = self.new(stmt=s, expr=s.iter)   # no narrowable test
        self._connect(preds, head)
        if can_raise(s.iter):
            head.edge(ctx.exc, EDGE_EXC)
        join = self.new(label="loop-exit")
        body_ctx = ctx.replace(brk=join, cont=head)
        body_out = self.seq(s.body, [(head, EDGE_TRUE)], body_ctx)
        self._connect(body_out, head)
        exit_preds: _Frontier = [(head, EDGE_FALSE)]
        if s.orelse:
            exit_preds = self.seq(s.orelse, exit_preds, ctx)
        self._connect(exit_preds, join)
        return [(join, EDGE_NORMAL)]

    def _with(self, s: ast.With | ast.AsyncWith, preds: _Frontier,
              ctx: _Ctx) -> _Frontier:
        # Context-manager protocol approximated: entering can raise,
        # the body runs, exits propagate (managers that swallow
        # exceptions are not modeled — none of the scoped protocols
        # hide behind one).
        for item in s.items:
            node = self.new(stmt=s, expr=item.context_expr)
            self._connect(preds, node)
            if can_raise(item.context_expr):
                node.edge(ctx.exc, EDGE_EXC)
            preds = [(node, EDGE_NORMAL)]
        return self.seq(s.body, preds, ctx)

    def _try(self, s: ast.Try, preds: _Frontier, ctx: _Ctx) -> _Frontier:
        if not s.finalbody:
            return self._try_core(s, preds, ctx)
        # finally: every way OUT of the protected region detours
        # through its own CLONE of the finally body, then continues to
        # the original target. Cloning (rather than a join node) keeps
        # per-path states separate — the whole point of the analysis.
        clones: dict[tuple[int, str], Node] = {}

        def fin(target: Node | None, kind: str) -> Node | None:
            if target is None:
                return None
            key = (id(target), kind)
            if key not in clones:
                entry = self.new(label="finally")
                out = self.seq(s.finalbody, [(entry, EDGE_NORMAL)], ctx)
                if kind == EDGE_EXC:
                    # The re-raise happens AFTER the finally body runs
                    # to completion: keep the clone's internal edge
                    # kinds intact (a t/f edge must stay narrowable —
                    # `finally: if h is not None: h.release()` relies
                    # on it) and mark only the final hop exceptional.
                    join = self.new(label="finally-reraise")
                    self._connect(out, join)
                    join.edge(target, EDGE_EXC)
                else:
                    for n, k in out:
                        n.edge(target, k)
                clones[key] = entry
            return clones[key]

        inner_ctx = _Ctx(
            exc=fin(ctx.exc, EDGE_EXC),
            ret=fin(ctx.ret, EDGE_NORMAL),
            brk=fin(ctx.brk, EDGE_NORMAL),
            cont=fin(ctx.cont, EDGE_NORMAL),
        )
        out = self._try_core(s, preds, inner_ctx)
        entry = self.new(label="finally")
        self._connect(out, entry)
        return self.seq(s.finalbody, [(entry, EDGE_NORMAL)], ctx)

    def _try_core(self, s: ast.Try, preds: _Frontier,
                  ctx: _Ctx) -> _Frontier:
        if not s.handlers:
            body_out = self.seq(s.body, preds, ctx)
            if s.orelse:
                body_out = self.seq(s.orelse, body_out, ctx)
            return body_out
        dispatch = self.new(label="exc-dispatch")
        body_ctx = ctx.replace(exc=dispatch)
        body_out = self.seq(s.body, preds, body_ctx)
        if s.orelse:
            body_out = self.seq(s.orelse, body_out, ctx)
        out = body_out
        catch_all = False
        for h in s.handlers:
            names = _handler_names(h)
            if h.type is None or names & _CATCH_ALL_NAMES:
                catch_all = True
            hnode = self.new(stmt=h, label="except")
            dispatch.edge(hnode, EDGE_NORMAL)
            out = out + self.seq(h.body, [(hnode, EDGE_NORMAL)], ctx)
        if not catch_all:
            # The exception may match no handler and keep propagating.
            dispatch.edge(ctx.exc, EDGE_EXC)
        return out


def _handler_names(h: ast.ExceptHandler) -> set[str]:
    if h.type is None:
        return set()
    types = h.type.elts if isinstance(h.type, ast.Tuple) else [h.type]
    names: set[str] = set()
    for t in types:
        # `except exc.SomeError` — the leaf attr is the class name.
        if isinstance(t, ast.Attribute):
            names.add(t.attr)
        elif isinstance(t, ast.Name):
            names.add(t.id)
    return names


def build_cfg(func: ast.FunctionDef | ast.AsyncFunctionDef) -> CFG:
    b = _Builder()
    entry = b.new(label="entry")
    exit_ = b.new(label="exit")
    exc_exit = b.new(label="exc-exit")
    ctx = _Ctx(exc=exc_exit, ret=exit_)
    out = b.seq(func.body, [(entry, EDGE_NORMAL)], ctx)
    for n, k in out:
        n.edge(exit_, k)
    cfg = CFG(entry, exit_, exc_exit)
    cfg.nodes = b.nodes
    return cfg


# ---------------------------------------------------------------- walker


def analyze(func: ast.FunctionDef | ast.AsyncFunctionDef, semantics: Any,
            max_states_per_node: int = 96,
            max_steps: int = 40_000) -> list[Any]:
    """Push `semantics` states through `func`'s CFG to a bounded
    fixpoint; returns the deduplicated, sorted findings."""
    cfg = build_cfg(func)
    findings: set[Any] = set()
    seen: dict[int, set[Any]] = {}
    init = semantics.initial()
    work: deque[tuple[Node, Any]] = deque([(cfg.entry, init)])
    seen[id(cfg.entry)] = {init}
    steps = 0
    while work and steps < max_steps:
        steps += 1
        node, st = work.popleft()
        if node is cfg.exit:
            findings.update(semantics.at_exit(st, False))
            continue
        if node is cfg.exc_exit:
            findings.update(semantics.at_exit(st, True))
            continue
        post, exc_st = st, st
        if node.stmt is not None:
            post, exc_st, fs = semantics.transfer(node, st)
            findings.update(fs)
        for succ, kind in node.succs:
            if kind == EDGE_EXC:
                nxt = exc_st
            elif kind in (EDGE_TRUE, EDGE_FALSE):
                nxt = semantics.on_branch(node.test, post,
                                          kind == EDGE_TRUE)
                if nxt is None:
                    continue
            else:
                nxt = post
            bucket = seen.setdefault(id(succ), set())
            if nxt not in bucket and len(bucket) < max_states_per_node:
                bucket.add(nxt)
                work.append((succ, nxt))
    return sorted(findings)


def iter_functions(tree: ast.AST) -> Iterator[ast.FunctionDef
                                              | ast.AsyncFunctionDef]:
    """Every def in the module, methods and nested defs included (each
    is analyzed as its own scope)."""
    for node in ast.walk(tree):
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            yield node


# ------------------------------------------------------- shared helpers


# The trackable-variable identity both flow checkers share: `a.b.c`
# for a Name/Attribute chain, None for anything computed. One
# implementation for the whole package — core.dotted_name.
dotted_path = dotted_name


def walk_scope(node: ast.AST | None) -> Iterator[ast.AST]:
    """ast.walk restricted to THIS execution scope: does not descend
    into nested def/lambda bodies (deferred code — their calls run
    when the closure runs, not at the definition statement; each
    nested def is analyzed as its own scope by iter_functions).
    Decorators and argument defaults DO evaluate at the definition, so
    those subtrees are walked."""
    if node is None:
        return
    todo = deque([node])
    while todo:
        n = todo.popleft()
        yield n
        if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef,
                          ast.Lambda)) and n is not node:
            if not isinstance(n, ast.Lambda):
                todo.extend(n.decorator_list)
            todo.extend(d for d in n.args.defaults + n.args.kw_defaults
                        if d is not None)
        else:
            todo.extend(ast.iter_child_nodes(n))


def assigned_paths(stmt: ast.AST) -> set[str]:
    """Every Name/Attribute dotted path this statement (re)binds:
    Assign/AnnAssign/AugAssign targets (tuple targets unpacked),
    for-loop targets, with ... as targets."""
    out: set[str] = set()

    def collect(t: ast.AST) -> None:
        if isinstance(t, (ast.Tuple, ast.List)):
            for e in t.elts:
                collect(e)
        elif isinstance(t, ast.Starred):
            collect(t.value)
        else:
            p = dotted_path(t)
            if p is not None:
                out.add(p)

    if isinstance(stmt, ast.Assign):
        for t in stmt.targets:
            collect(t)
    elif isinstance(stmt, (ast.AnnAssign, ast.AugAssign)):
        collect(stmt.target)
    elif isinstance(stmt, (ast.For, ast.AsyncFor)):
        collect(stmt.target)
    elif isinstance(stmt, (ast.With, ast.AsyncWith)):
        for item in stmt.items:
            if item.optional_vars is not None:
                collect(item.optional_vars)
    return out
