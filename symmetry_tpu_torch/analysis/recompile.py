"""Recompile-hazard checker: compile-cache stability inside jit traces.

The serving engine's core contract is ZERO steady-state recompiles:
every prefill/decode/verify dispatch must hit a compiled program from
the warmup grid (tests assert `engine.compile_cache_sizes()` is flat
across traffic). The hazards that break it are all Python-level and
all statically visible inside a jit-traced function:

  R301  `int()` / `float()` / `bool()` / `.item()` / `.tolist()` on a
        traced value — forces a device→host sync at trace time and
        bakes the VALUE into the compiled program, so every new value
        is a new compile
  R302  `if` / `while` on a traced value — a data-dependent Python
        branch; each branch outcome traces (and compiles) its own
        program (shape/dtype/ndim predicates are fine: those are
        static under jit)
  R303  `np.asarray` / `np.array` / `jax.device_get` on a traced
        value — a silent host round-trip inside the trace

Traced functions are found two ways, matching how the engine builds
its programs:

  - decorated: `@jax.jit`, `@partial(jax.jit, static_argnames=…)`,
    `@functools.partial(jax.jit, …)`
  - wrapped at call sites: `jax.jit(fn, …)` where `fn` is a function
    defined anywhere in the same module (the engine's
    `self._prefill = jax.jit(prefill, donate_argnums=…)` pattern)

Static arguments (`static_argnames` / `static_argnums`) are exempt
from taint: branching on them is exactly what they are for. Taint then
flows forward through local assignments; `.shape`, `.ndim`, `.dtype`,
`.size` and `len()` sanitize, because those are Python values at trace
time.
"""

from __future__ import annotations

import ast

from symmetry_tpu_torch.analysis.core import (
    CheckerSpec,
    Finding,
    Project,
    SourceFile,
    call_name,
    const_str,
    dotted_name,
)

NAME = "recompile-hazard"

# Scope: the jit-traced tiers (ISSUE list). The network/server tiers
# never trace; tests trace deliberately-weird shapes on purpose.
SCOPE = (
    "symmetry_tpu_torch/engine/engine.py",
    "symmetry_tpu_torch/engine/spec/*.py",
    "symmetry_tpu_torch/ops/*.py",
    "symmetry_tpu_torch/models/*.py",
)

_SANITIZING_ATTRS = {"shape", "ndim", "dtype", "size", "itemsize",
                     "sharding", "weak_type"}
_SANITIZING_CALLS = {"len", "isinstance", "type", "hasattr", "getattr",
                     "range", "min", "max", "enumerate", "zip"}
# min/max over shape ints stay static; over tracers they return tracers,
# but flagging them would drown the real findings — the converging
# int()/branch site downstream still flags.
_VALUE_SYNC_CALLS = {"int", "float", "bool"}
_VALUE_SYNC_METHODS = {"item", "tolist"}
_HOST_PULL_CALLS = {"np.asarray", "np.array", "numpy.asarray",
                    "numpy.array", "onp.asarray", "onp.array",
                    "jax.device_get"}


def _jit_static(call: ast.Call) -> tuple[set[str], set[int]]:
    """static_argnames / static_argnums sets from a jit(…) call."""
    names: set[str] = set()
    nums: set[int] = set()
    for kw in call.keywords:
        if kw.arg == "static_argnames":
            vals = (kw.value.elts
                    if isinstance(kw.value, (ast.Tuple, ast.List))
                    else [kw.value])
            for v in vals:
                s = const_str(v)
                if s is not None:
                    names.add(s)
        elif kw.arg == "static_argnums":
            vals = (kw.value.elts
                    if isinstance(kw.value, (ast.Tuple, ast.List))
                    else [kw.value])
            for v in vals:
                if isinstance(v, ast.Constant) and isinstance(v.value, int):
                    nums.add(v.value)
    return names, nums


def _is_jit_name(node: ast.AST) -> bool:
    return dotted_name(node) in ("jax.jit", "jit")


def _find_traced(sf: SourceFile) -> list[tuple[ast.AST, set[str]]]:
    """(FunctionDef, static param names) for every function the module
    traces under jit. Keyed by NODE identity, not name: two builder
    methods each defining a nested `def step` and jit-wrapping it are
    two distinct traced functions — a name-keyed registry would analyze
    the first and silently skip the second."""
    # All function defs in the module, grouped by name (nested included
    # — the engine defines its programs inside builder methods).
    defs_by_name: dict[str, list[ast.AST]] = {}
    for node in ast.walk(sf.tree):
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            defs_by_name.setdefault(node.name, []).append(node)

    traced: dict[int, tuple[ast.AST, set[str]]] = {}

    def param_names(fn: ast.AST) -> list[str]:
        a = fn.args
        return [p.arg for p in (a.posonlyargs + a.args + a.kwonlyargs)]

    def add(fn: ast.AST, names: set[str], nums: set[int]) -> None:
        params = param_names(fn)
        static = set(names)
        for i in nums:
            if 0 <= i < len(params):
                static.add(params[i])
        traced[id(fn)] = (fn, static)

    # Decorated defs.
    for node in ast.walk(sf.tree):
        if not isinstance(node, ast.FunctionDef):
            continue
        for dec in node.decorator_list:
            if _is_jit_name(dec):
                add(node, set(), set())
            elif isinstance(dec, ast.Call):
                cn = call_name(dec)
                if cn in ("functools.partial", "partial") and dec.args \
                        and _is_jit_name(dec.args[0]):
                    names, nums = _jit_static(dec)
                    add(node, names, nums)
                elif _is_jit_name(dec.func):
                    names, nums = _jit_static(dec)
                    add(node, names, nums)
    # Call-site wrapping: jax.jit(fn, …). A name can resolve to several
    # defs (same-named program builders in different scopes); every one
    # is analyzed — over-approximating beats silently skipping the
    # second definition.
    for node in ast.walk(sf.tree):
        if (isinstance(node, ast.Call) and _is_jit_name(node.func)
                and node.args and isinstance(node.args[0], ast.Name)):
            for fn in defs_by_name.get(node.args[0].id, ()):
                if id(fn) not in traced:
                    names, nums = _jit_static(node)
                    add(fn, names, nums)
    return list(traced.values())


class _TaintWalker:
    """Forward taint pass over one traced function body. Deliberately
    simple: once a local is tainted it stays tainted (loops/branches
    join conservatively) unless reassigned from a clean expression."""

    def __init__(self, sf: SourceFile, fn: ast.AST,
                 static: set[str]) -> None:
        self.sf = sf
        self.fn = fn
        a = fn.args
        params = [p.arg for p in (a.posonlyargs + a.args + a.kwonlyargs)]
        self.tainted: set[str] = {p for p in params if p not in static}
        self.findings: list[Finding] = []

    # ----------------------------------------------------- expressions

    def taint(self, node: ast.AST) -> bool:
        if isinstance(node, ast.Name):
            return node.id in self.tainted
        if isinstance(node, ast.Attribute):
            if node.attr in _SANITIZING_ATTRS:
                return False
            return self.taint(node.value)
        if isinstance(node, ast.Call):
            cn = call_name(node)
            if cn in _SANITIZING_CALLS:
                return False
            # method calls on a tainted receiver stay tainted; any
            # tainted argument taints the result
            parts = ([node.func.value] if isinstance(node.func,
                                                     ast.Attribute)
                     else [])
            return any(self.taint(x) for x in
                       parts + list(node.args)
                       + [kw.value for kw in node.keywords])
        if isinstance(node, ast.Subscript):
            return self.taint(node.value) or self.taint(node.slice)
        if isinstance(node, (ast.BinOp,)):
            return self.taint(node.left) or self.taint(node.right)
        if isinstance(node, ast.UnaryOp):
            return self.taint(node.operand)
        if isinstance(node, ast.BoolOp):
            return any(self.taint(v) for v in node.values)
        if isinstance(node, ast.Compare):
            # `x is None` / `x is not None` is an argument-STRUCTURE
            # predicate — static at trace time, not a value branch.
            if all(isinstance(op, (ast.Is, ast.IsNot))
                   for op in node.ops):
                return False
            return self.taint(node.left) or any(
                self.taint(c) for c in node.comparators)
        if isinstance(node, ast.IfExp):
            return any(self.taint(x)
                       for x in (node.test, node.body, node.orelse))
        if isinstance(node, (ast.Tuple, ast.List, ast.Set)):
            return any(self.taint(e) for e in node.elts)
        if isinstance(node, ast.Starred):
            return self.taint(node.value)
        if isinstance(node, ast.JoinedStr):
            return False
        return False

    def _emit(self, code: str, node: ast.AST, msg: str,
              symbol: str) -> None:
        self.findings.append(Finding(
            checker=NAME, code=code, path=self.sf.rel,
            line=node.lineno, message=msg,
            symbol=f"{self.fn.name}:{symbol}"))

    def _scan_calls(self, node: ast.AST) -> None:
        """R301/R303 call hazards anywhere inside one statement."""
        for sub in ast.walk(node):
            if not isinstance(sub, ast.Call):
                continue
            cn = call_name(sub)
            if (cn in _VALUE_SYNC_CALLS and sub.args
                    and self.taint(sub.args[0])):
                self._emit(
                    "R301", sub,
                    f"{cn}() on a traced value inside jit function "
                    f"'{self.fn.name}' — bakes the value into the "
                    f"compiled program (one compile per value)", cn)
            elif (isinstance(sub.func, ast.Attribute)
                  and sub.func.attr in _VALUE_SYNC_METHODS
                  and self.taint(sub.func.value)):
                self._emit(
                    "R301", sub,
                    f".{sub.func.attr}() on a traced value inside jit "
                    f"function '{self.fn.name}' — device→host sync at "
                    f"trace time", f".{sub.func.attr}")
            elif cn in _HOST_PULL_CALLS and sub.args \
                    and self.taint(sub.args[0]):
                self._emit(
                    "R303", sub,
                    f"{cn}() on a traced value inside jit function "
                    f"'{self.fn.name}' — host round-trip inside the "
                    f"trace", cn)

    # ------------------------------------------------------ statements

    def run(self) -> list[Finding]:
        for stmt in self.fn.body:
            self.stmt(stmt)
        return self.findings

    def stmt(self, node: ast.AST) -> None:
        if not isinstance(node, (ast.If, ast.While, ast.For, ast.With,
                                 ast.Try, ast.FunctionDef,
                                 ast.AsyncFunctionDef)):
            # Simple statement: hazard-scan its expressions once.
            # (Compound statements scan only their header expressions
            # here and recurse into bodies statement-by-statement, so
            # nothing is scanned twice.)
            self._scan_calls(node)
        if isinstance(node, (ast.If, ast.While)):
            self._scan_calls(node.test)
            if self.taint(node.test):
                kind = "if" if isinstance(node, ast.If) else "while"
                self._emit(
                    "R302", node,
                    f"data-dependent `{kind}` on a traced value inside "
                    f"jit function '{self.fn.name}' — each outcome "
                    f"traces its own program; use lax.cond/select or a "
                    f"static argument", kind)
            for child in node.body + node.orelse:
                self.stmt(child)
            return
        if isinstance(node, ast.Assign):
            val_taint = self.taint(node.value)
            for t in node.targets:
                self._bind(t, val_taint)
            return
        if isinstance(node, ast.AnnAssign) and node.value is not None:
            self._bind(node.target, self.taint(node.value))
            return
        if isinstance(node, ast.AugAssign):
            if isinstance(node.target, ast.Name):
                if self.taint(node.value):
                    self.tainted.add(node.target.id)
            return
        if isinstance(node, ast.For):
            self._scan_calls(node.iter)
            self._bind(node.target, self.taint(node.iter))
            for child in node.body + node.orelse:
                self.stmt(child)
            return
        if isinstance(node, ast.With):
            for item in node.items:
                self._scan_calls(item.context_expr)
            for child in node.body:
                self.stmt(child)
            return
        if isinstance(node, ast.Try):
            for child in (node.body + node.orelse + node.finalbody
                          + [s for h in node.handlers for s in h.body]):
                self.stmt(child)
            return
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            # Nested helper: its body traces too when called, with the
            # enclosing scope visible — keep walking with shared taint.
            for child in node.body:
                self.stmt(child)
            return

    def _bind(self, target: ast.AST, tainted: bool) -> None:
        if isinstance(target, ast.Name):
            if tainted:
                self.tainted.add(target.id)
            else:
                self.tainted.discard(target.id)
        elif isinstance(target, (ast.Tuple, ast.List)):
            for elt in target.elts:
                self._bind(elt, tainted)


def check(project: Project) -> list[Finding]:
    findings: list[Finding] = []
    for sf in project.select(SCOPE):
        for fn, static in _find_traced(sf):
            findings.extend(_TaintWalker(sf, fn, static).run())
    return findings


SPEC = CheckerSpec(
    name=NAME,
    doc="value syncs / data-dependent branches inside jit traces",
    run=check,
    codes=("R301", "R302", "R303"),
)
