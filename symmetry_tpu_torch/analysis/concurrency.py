"""Concurrency checker: cross-thread mutation and async-blocking calls.

The system is two concurrency regimes glued together: a threaded engine
tier (scheduler loop, engine-host pipe reader, multihost command loop)
and an asyncio provider/client/server tier. Each has one
characteristic failure this checker makes static:

  C201  blocking call inside an `async def` body — `time.sleep`, sync
        subprocess APIs, `Future.result()`, sync socket connects: each
        stalls the WHOLE event loop, which in this codebase means every
        client's stream at once (the exact pathology that forced the
        engine out of the provider process; see engine/host.py)
  C202  attribute mutated from more than one thread entry point with at
        least one mutation site not under a lock — the lost-update race
        on shared counters/maps
  C203  an UNBOUNDED queue.Queue/SimpleQueue used as a cross-thread
        channel (put sites and get sites reachable from different
        thread contexts) — a consumer that stalls lets the producer
        grow it without limit, which in a serving process is an OOM
        with a delay fuse. Bounded construction (any nonzero maxsize)
        is the fix: the blocking put IS the backpressure. Queues whose
        depth is bounded upstream (a provider admission cap, a
        handshake window) are baseline entries with that argument
        written down. asyncio.Queue is exempt — its producers and
        consumers share the loop thread, and flow control there is the
        loop's problem, not a thread-safety one.

Thread entry points are inferred per class:

  - methods passed as `threading.Thread(target=self.X)` targets
  - methods whose bound reference ESCAPES the class without being
    called (`emit_batch=self._emit_batch`, `handoff=self._handoff_sink`)
    — a callback handed to other machinery runs on that machinery's
    thread, which is exactly how the scheduler calls back into the
    engine host

Entry contexts propagate through the intra-class `self.foo()` call
graph; public methods are additionally reachable from "main" (any
caller thread). A mutation site counts as locked when it sits
lexically inside `with self.<something-lock-ish>:`. `__init__` is
exempt — nothing else is running yet.

The checker is deliberately an over-approximation: a per-request dict
key that is only ever touched by one thread at a time still flags.
Those are baseline entries with the ownership argument written down —
which is the point: the invariant is now stated somewhere a reviewer
(and the next refactor) can see it.
"""

from __future__ import annotations

import ast

from symmetry_tpu_torch.analysis.core import (
    CheckerSpec,
    Finding,
    Project,
    SourceFile,
    call_name,
    dotted_name,
)

NAME = "concurrency"

# Scope: the whole package. Tools and tests host no long-lived threads
# worth modeling and drive event loops synchronously on purpose.
SCOPE = ("symmetry_tpu_torch/**",)

# C201: dotted callee names that block the calling thread. Methods that
# cannot be resolved statically (bare `.recv()` etc.) are left alone —
# the checker prefers silence to noise.
BLOCKING_CALLS = {
    "time.sleep",
    "subprocess.run", "subprocess.call", "subprocess.check_call",
    "subprocess.check_output", "subprocess.getoutput", "subprocess.Popen",
    "socket.create_connection", "socket.getaddrinfo",
    "os.system", "os.waitpid", "os.wait",
    "requests.get", "requests.post", "requests.put", "requests.request",
    "urllib.request.urlopen",
}

# Zero-arg method names that block when called on a concurrent.futures
# future / thread handle inside async code.
BLOCKING_METHODS = {"result"}

_LOCKISH = ("lock", "mutex", "cond")

# Container methods that mutate their receiver in place — the
# `self.stats.update(...)` / `self._cancelled.discard(...)` mutation
# shapes Assign/AugAssign extraction cannot see. Queue/deque handoff
# verbs (put/get/popleft…) are deliberately absent: those types are the
# codebase's sanctioned cross-thread channels and flagging them would
# drown the real races.
_MUTATOR_METHODS = {"append", "add", "pop", "remove", "discard", "clear",
                    "update", "extend", "insert", "setdefault", "popitem"}

# C203: thread-queue constructors. asyncio.Queue is excluded at the
# call-name level (loop-internal flow control, not a thread channel).
_QUEUE_TYPES = {"Queue", "SimpleQueue", "LifoQueue", "PriorityQueue"}

# Queue handoff verbs, split by side: the channel counts as cross-thread
# when put-side and get-side contexts are not the same single thread.
_QUEUE_PUTS = {"put", "put_nowait"}
_QUEUE_GETS = {"get", "get_nowait"}


def _queue_bounded(call: ast.Call, leaf: str) -> bool:
    """Is this queue construction bounded? SimpleQueue has no maxsize at
    all. Queue's maxsize (first positional or keyword) bounds it iff
    positive; absent or constant <= 0 means infinite. A COMPUTED
    maxsize (maxsize=max(1, n)) is taken as bounded — the checker
    prefers silence to noise on expressions it cannot evaluate."""
    if leaf == "SimpleQueue":
        return False
    size: ast.AST | None = call.args[0] if call.args else None
    for kw in call.keywords:
        if kw.arg == "maxsize":
            size = kw.value
    if size is None:
        return False
    if isinstance(size, ast.Constant):
        return isinstance(size.value, (int, float)) and size.value > 0
    return True


def _lock_name(expr: ast.AST) -> str | None:
    """The identity of a lock-ish `with` context expression, else None.
    Identity matters: two sites holding DIFFERENT locks do not exclude
    each other."""
    dn = dotted_name(expr)
    if dn is None and isinstance(expr, ast.Call):
        dn = call_name(expr)
    if dn is None:
        return None
    leaf = dn.split(".")[-1].lower()
    return dn if any(tok in leaf for tok in _LOCKISH) else None


# ------------------------------------------------------------------ C201


def _check_async_blocking(sf: SourceFile) -> list[Finding]:
    findings: list[Finding] = []

    def visit_async_body(fn: ast.AsyncFunctionDef) -> None:
        # Walk the async body but do not descend into nested defs: a
        # sync helper defined inside (e.g. shipped to a thread pool via
        # run_in_executor / to_thread) is allowed to block, and a
        # nested ASYNC def gets its own visit from the module walk —
        # descending here would double-report its findings.
        stack: list[ast.AST] = list(ast.iter_child_nodes(fn))
        while stack:
            node = stack.pop()
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                                 ast.Lambda)):
                continue
            if isinstance(node, ast.Call):
                cn = call_name(node)
                if cn is not None and (
                        cn in BLOCKING_CALLS
                        or any(cn.endswith("." + b)
                               for b in BLOCKING_CALLS)):
                    findings.append(Finding(
                        checker=NAME, code="C201", path=sf.rel,
                        line=node.lineno, symbol=f"{fn.name}:{cn}",
                        message=(f"blocking call {cn}() inside "
                                 f"async def {fn.name} — stalls the "
                                 f"whole event loop; use the asyncio "
                                 f"equivalent or run_in_executor")))
                elif (isinstance(node.func, ast.Attribute)
                      and node.func.attr in BLOCKING_METHODS
                      and not node.args
                      and all(kw.arg == "timeout"
                              for kw in node.keywords)
                      and not isinstance(
                          getattr(node, "sym_parent", None), ast.Await)):
                    findings.append(Finding(
                        checker=NAME, code="C201", path=sf.rel,
                        line=node.lineno,
                        symbol=f"{fn.name}:.{node.func.attr}",
                        message=(f".{node.func.attr}() inside async def "
                                 f"{fn.name} blocks the event loop if "
                                 f"the receiver is a concurrent.futures "
                                 f"handle — await it instead")))
            stack.extend(ast.iter_child_nodes(node))

    for node in ast.walk(sf.tree):
        if isinstance(node, ast.AsyncFunctionDef):
            visit_async_body(node)
    return findings


# ------------------------------------------------------------------ C202


class _ClassModel:
    def __init__(self, cls: ast.ClassDef) -> None:
        self.cls = cls
        self.methods: dict[str, ast.AST] = {}
        for stmt in cls.body:
            if isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef)):
                self.methods[stmt.name] = stmt
        self.roots: set[str] = set()       # foreign-thread entry methods
        # Escaped local closures: a `def emit(…)` / thunk defined inside
        # a method and handed to other machinery (the scheduler, an
        # executor) runs on THAT machinery's thread. pseudo-entry name →
        # defining method.
        self.escaped_closures: dict[str, str] = {}
        self.calls: dict[str, set[str]] = {}   # context -> self-calls
        # mutation unit -> list of (context, line, held-lock names)
        self.mutations: dict[str, list[tuple[str, int,
                                             frozenset[str]]]] = {}
        # C203: queue attr -> (construction line, bounded?), and
        # queue attr -> [(side "put"/"get", context, line)]. Ops are
        # recorded for EVERY attr that quacks like a queue and filtered
        # against the constructed set at verdict time, so dict .get()
        # noise never reaches a finding.
        self.queues: dict[str, tuple[int, bool]] = {}
        self.queue_ops: dict[str, list[tuple[str, str, int]]] = {}

    def contexts(self) -> dict[str, set[str]]:
        """Entry-context sets per context (method or escaped closure):
        thread roots and escaped closures seed their own label, public
        methods seed "main"; labels flow caller→callee through the
        self-call graph to a fixpoint."""
        ctx: dict[str, set[str]] = {name: set() for name in self.methods}
        for name in self.methods:
            if name in self.roots:
                ctx[name].add(f"thread:{name}")
            if not name.startswith("_"):
                ctx[name].add("main")
        for pseudo in self.escaped_closures:
            ctx[pseudo] = {f"closure:{pseudo}"}
        changed = True
        while changed:
            changed = False
            for caller, callees in self.calls.items():
                for callee in callees:
                    if callee not in ctx or caller not in ctx:
                        continue
                    before = len(ctx[callee])
                    ctx[callee] |= ctx[caller]
                    changed = changed or len(ctx[callee]) != before
        return ctx


def _self_attr(node: ast.AST) -> str | None:
    """`attr` for `self.attr` (one level only)."""
    if (isinstance(node, ast.Attribute)
            and isinstance(node.value, ast.Name)
            and node.value.id == "self"):
        return node.attr
    return None


def _mutated_attr(target: ast.AST) -> str | None:
    """The mutation unit a store target touches. Key-granular for
    constant subscripts — `self.metrics["requests"] += 1` races with
    other writers of `metrics["requests"]`, not with the engine
    thread's `metrics["tokens"]` (dict item ops are GIL-atomic per
    key) — attr-granular for plain stores and dynamic keys."""
    if isinstance(target, ast.Subscript):
        attr = _self_attr(target.value)
        if attr is None:
            return None
        key = (target.slice.value
               if isinstance(target.slice, ast.Constant)
               and isinstance(target.slice.value, (str, int))
               else None)
        return f"{attr}[{key!r}]" if key is not None else attr
    return _self_attr(target)


def _build_model(cls: ast.ClassDef) -> _ClassModel:
    model = _ClassModel(cls)
    for name, fn in model.methods.items():
        # Local functions whose NAME escapes the method (referenced
        # other than as a direct callee — passed as a callback, stored
        # on a request object): their bodies run in whatever context
        # the receiver calls them from, which in this codebase means
        # another thread more often than not.
        nested: dict[str, ast.AST] = {}
        for sub in ast.walk(fn):
            if sub is not fn and isinstance(
                    sub, (ast.FunctionDef, ast.AsyncFunctionDef)):
                nested.setdefault(sub.name, sub)
        escaped: set[str] = set()
        for sub in ast.walk(fn):
            if (isinstance(sub, ast.Name) and sub.id in nested
                    and isinstance(sub.ctx, ast.Load)):
                parent = getattr(sub, "sym_parent", None)
                if not (isinstance(parent, ast.Call)
                        and parent.func is sub):
                    escaped.add(sub.id)
        pseudo_of: dict[ast.AST, str] = {}
        for dname in escaped:
            pname = f"{name}.<{dname}>"
            model.escaped_closures[pname] = name
            pseudo_of[nested[dname]] = pname

        def walk(node: ast.AST, held: frozenset, owner: str,
                 pseudo_of: dict[ast.AST, str] = pseudo_of) -> None:
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)) \
                    and node in pseudo_of:
                inner_owner = pseudo_of[node]
                for child in node.body:
                    walk(child, frozenset(), inner_owner)
                return
            if isinstance(node, ast.With):
                inner = held | {n for n in (
                    _lock_name(item.context_expr)
                    for item in node.items) if n is not None}
                for item in node.items:
                    walk(item.context_expr, held, owner)
                for child in node.body:
                    walk(child, inner, owner)
                return
            if isinstance(node, ast.Call):
                # threading.Thread(target=self.x) → root
                cn = call_name(node)
                if cn is not None and cn.split(".")[-1] == "Thread":
                    for kw in node.keywords:
                        if kw.arg == "target":
                            t = _self_attr(kw.value)
                            if t in model.methods:
                                model.roots.add(t)
                # self.foo(...) → call edge from the current context
                callee = _self_attr(node.func)
                if callee in model.methods:
                    model.calls.setdefault(owner, set()).add(callee)
                # self.x.update(...) / self._s.discard(...) — in-place
                # container mutation through a method call
                if (isinstance(node.func, ast.Attribute)
                        and node.func.attr in _MUTATOR_METHODS):
                    unit = _mutated_attr(node.func.value)
                    if unit is not None:
                        model.mutations.setdefault(unit, []).append(
                            (owner, node.lineno, held))
                # self.q.put(...) / self.q.get(...) — queue handoff
                # sites for the C203 cross-thread-channel verdict
                if (isinstance(node.func, ast.Attribute)
                        and node.func.attr in (_QUEUE_PUTS | _QUEUE_GETS)):
                    unit = _self_attr(node.func.value)
                    if unit is not None:
                        side = ("put" if node.func.attr in _QUEUE_PUTS
                                else "get")
                        model.queue_ops.setdefault(unit, []).append(
                            (side, owner, node.lineno))
            if isinstance(node, ast.Attribute):
                # a bound-method reference that is NOT the callee of a
                # call escapes → foreign-context entry point. Async
                # methods are exempt: a coroutine handed out as a
                # callback still runs on the event loop's one thread.
                attr = _self_attr(node)
                parent = getattr(node, "sym_parent", None)
                is_callee = (isinstance(parent, ast.Call)
                             and parent.func is node)
                if (attr in model.methods and not is_callee
                        and isinstance(node.ctx, ast.Load)
                        and isinstance(model.methods[attr],
                                       ast.FunctionDef)):
                    model.roots.add(attr)
            if isinstance(node, (ast.Assign, ast.AugAssign, ast.AnnAssign)):
                # self.q = queue.Queue(...) — remember the channel and
                # whether its construction bounded it (C203)
                value = getattr(node, "value", None)
                if isinstance(value, ast.Call):
                    cn = call_name(value)
                    leaf = cn.split(".")[-1] if cn else ""
                    if (leaf in _QUEUE_TYPES and cn is not None
                            and "asyncio" not in cn):
                        qtargets = (node.targets
                                    if isinstance(node, ast.Assign)
                                    else [node.target])
                        for t in qtargets:
                            qattr = _self_attr(t)
                            if qattr is not None:
                                model.queues[qattr] = (
                                    node.lineno,
                                    _queue_bounded(value, leaf))
                targets = (node.targets if isinstance(node, ast.Assign)
                           else [node.target])
                for t in targets:
                    elts = (t.elts if isinstance(t, (ast.Tuple, ast.List))
                            else [t])
                    for elt in elts:
                        attr = _mutated_attr(elt)
                        if attr is not None:
                            model.mutations.setdefault(attr, []).append(
                                (owner, elt.lineno, held))
            for child in ast.iter_child_nodes(node):
                walk(child, held, owner)

        for stmt in (fn.body if hasattr(fn, "body") else []):
            walk(stmt, frozenset(), name)
    return model


def _check_cross_thread(sf: SourceFile) -> list[Finding]:
    findings: list[Finding] = []
    for node in ast.walk(sf.tree):
        if not isinstance(node, ast.ClassDef):
            continue
        model = _build_model(node)
        if not model.roots and not model.escaped_closures:
            continue  # single-context class: nothing to race with
        ctx = model.contexts()
        # Whole-container mutation (self.stats.update(…), self.stats =
        # …) races with EVERY key-granular write of the same attribute:
        # fold the attr-level sites into each of its key units so the
        # two granularities collide instead of passing each other by.
        mutations = dict(model.mutations)
        for unit, sites in model.mutations.items():
            if "[" in unit:
                base = unit.split("[", 1)[0]
                if base in model.mutations:
                    mutations[unit] = sites + model.mutations[base]
        for attr, sites in mutations.items():
            live = [(m, ln, held) for m, ln, held in sites
                    if m != "__init__"]
            labels: set[str] = set()
            for method, _line, _held in live:
                labels |= ctx.get(method, set())
            if len(labels) < 2:
                continue
            # Protected only if ONE COMMON lock is held at every
            # site — different locks do not exclude each other.
            common = None
            for _m, _ln, held in live:
                common = held if common is None else common & held
            if common:
                continue
            unlocked = sorted((m, ln) for m, ln, held in live
                              if not held)
            if unlocked:
                problem = f"{len(unlocked)} unlocked site(s)"
            else:
                # Every site holds SOME lock, but no single lock is
                # common to all — "unlocked" would send the reader
                # hunting for a `with` that is already there.
                unlocked = sorted((m, ln) for m, ln, _h in live)
                problem = (f"no common lock across its "
                           f"{len(unlocked)} sites (different locks "
                           f"do not exclude each other)")
            m, ln = unlocked[0]
            findings.append(Finding(
                checker=NAME, code="C202", path=sf.rel, line=ln,
                symbol=f"{node.name}.{attr}",
                message=(f"self.{attr} is mutated from "
                         f"{len(labels)} thread contexts "
                         f"({', '.join(sorted(labels))}) with "
                         f"{problem} "
                         f"(first: {node.name}.{m}) — guard with a "
                         f"lock or record the ownership argument in "
                         f"the baseline")))
        # C203: an unbounded queue whose put side and get side are
        # reachable from different thread contexts is a cross-thread
        # channel with no backpressure.
        for attr, (line, bounded) in sorted(model.queues.items()):
            if bounded:
                continue
            put_labels: set[str] = set()
            get_labels: set[str] = set()
            for side, owner, _ln in model.queue_ops.get(attr, []):
                labels = ctx.get(owner, set())
                if side == "put":
                    put_labels |= labels
                else:
                    get_labels |= labels
            if not put_labels or not get_labels:
                continue
            if len(put_labels | get_labels) < 2:
                continue  # one thread talking to itself: no backlog race
            findings.append(Finding(
                checker=NAME, code="C203", path=sf.rel, line=line,
                symbol=f"{node.name}.{attr}",
                message=(f"self.{attr} is an unbounded queue crossing "
                         f"thread contexts (put: "
                         f"{', '.join(sorted(put_labels))}; get: "
                         f"{', '.join(sorted(get_labels))}) — a stalled "
                         f"consumer grows it without limit; construct "
                         f"with a nonzero maxsize so the blocking put "
                         f"is the backpressure, or record the upstream "
                         f"bound in the baseline")))
    return findings


def check(project: Project) -> list[Finding]:
    findings: list[Finding] = []
    for sf in project.select(SCOPE):
        findings.extend(_check_async_blocking(sf))
        findings.extend(_check_cross_thread(sf))
    return findings


SPEC = CheckerSpec(
    name=NAME,
    doc="cross-thread mutation without a lock; blocking calls in async; "
        "unbounded cross-thread queues",
    run=check,
    codes=("C201", "C202", "C203"),
)
