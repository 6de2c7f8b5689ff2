"""The port's static-analysis suite (symmetry_tpu_torch/analysis/, run as
`python -m symmetry_tpu_torch.analysis`), held to tests/test_analysis.py's
cases for the JAX package's suite.

Per checker: a seeded true positive (the drift the checker exists to
catch) and a true negative (the idiomatic clean shape must not flag), in
fixture trees laid out as the port (`symmetry_tpu_torch/...`). Plus:
baseline suppression semantics, the runner's JSON and SARIF output and
exit codes, the port's registry lookups reading the port's files when
the JAX package defines the same classes, and the self-test: the port's
tree runs clean modulo its justified baseline
(symmetry_tpu_torch/analysis/baseline.json).
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import threading

import pytest

from symmetry_tpu_torch.analysis import ALL_CHECKERS, Baseline, run

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

KEYS_PY = '''\
class HostOp:
    SUBMIT = "submit"
    EVENT = "event"
    EVENTS = "events"


class MessageKey:
    PING = "ping"
    PONG = "pong"
'''


def write_tree(root, files: dict[str, str]) -> str:
    for rel, src in files.items():
        path = os.path.join(root, rel)
        os.makedirs(os.path.dirname(path), exist_ok=True)
        with open(path, "w", encoding="utf-8") as fh:
            fh.write(src)
    return str(root)


def codes(findings) -> set[str]:
    return {f.code for f in findings}


# ------------------------------------------------------------ wire-contract


class TestWireContract:
    def test_mismatch_and_raw_literal_flag(self, tmp_path):
        root = write_tree(tmp_path, {
            "symmetry_tpu_torch/protocol/keys.py": KEYS_PY,
            # producer emits a typo'd op, plus a registered op spelled
            # as a raw literal…
            "symmetry_tpu_torch/engine/host.py": (
                'def emit(w):\n'
                '    w({"op": "evnt", "id": "r1"})\n'
                '    w({"op": "submit", "id": "r1"})\n'),
            # …while the consumer dispatches on the real one
            "symmetry_tpu_torch/provider/backends/tpu_native.py": (
                'from symmetry_tpu_torch.protocol.keys import HostOp\n'
                'def pump(msg):\n'
                '    op = msg.get("op")\n'
                '    if op == HostOp.EVENT:\n'
                '        return msg\n'),
        })
        fs = run(root)
        got = codes(fs)
        assert "W102" in got     # "evnt" produced, never consumed
        assert "W103" in got     # "event" consumed, never produced
        assert "W104" in got     # "evnt" unknown to HostOp
        assert "W101" in got     # raw literal in a registry'd group file
        syms = {f.symbol for f in fs if f.code == "W102"}
        assert syms == {"evnt", "submit"}  # both lack a consumer

    def test_clean_when_both_sides_use_constants(self, tmp_path):
        root = write_tree(tmp_path, {
            "symmetry_tpu_torch/protocol/keys.py": KEYS_PY,
            "symmetry_tpu_torch/engine/host.py": (
                'from symmetry_tpu_torch.protocol.keys import HostOp\n'
                'def emit(w):\n'
                '    w({"op": HostOp.EVENT, "id": "r1"})\n'
                '    m = {}\n'
                '    m["op"] = HostOp.EVENTS\n'
                '    w(m)\n'),
            "symmetry_tpu_torch/provider/backends/tpu_native.py": (
                'from symmetry_tpu_torch.protocol.keys import HostOp\n'
                'def pump(msg):\n'
                '    op = msg.get("op")\n'
                '    if op in (HostOp.EVENT, HostOp.EVENTS):\n'
                '        return msg\n'),
        })
        assert run(root) == []

    def test_link_op_group_mismatch_and_raw_literal(self, tmp_path):
        """The handoff-link protocol (LinkOp, engine/disagg/net.py +
        node.py) gets the same W101–W104 discipline over its own group
        — and LinkOp's deliberate HostOp value reuse must NOT leak
        across registries (a LinkOp.X reference is invisible to the
        HostOp scan and vice versa)."""
        root = write_tree(tmp_path, {
            "symmetry_tpu_torch/protocol/keys.py": (
                KEYS_PY + '\n\n'
                'class LinkOp:\n'
                '    SUBMIT = "submit"\n'
                '    BEGIN = "begin"\n'
                '    CHUNK = "chunk"\n'),
            # link producer: raw literal for a registered link op, plus
            # an op consumed nowhere in the link group
            "symmetry_tpu_torch/engine/disagg/net.py": (
                'from symmetry_tpu_torch.protocol.keys import LinkOp\n'
                'async def send(link):\n'
                '    await link.send({"op": "begin", "xfer": "x"})\n'
                '    await link.send({"op": LinkOp.CHUNK, "seq": 0})\n'),
            "symmetry_tpu_torch/engine/disagg/node.py": (
                'from symmetry_tpu_torch.protocol.keys import LinkOp\n'
                'def pump(header):\n'
                '    op = header.get("op")\n'
                '    if op == LinkOp.CHUNK:\n'
                '        return header\n'
                '    if op == LinkOp.SUBMIT:\n'
                '        return header\n'),
        })
        fs = [f for f in run(root) if f.checker == "wire-contract"]
        got = codes(fs)
        assert "W101" in got     # raw "begin" literal in the link group
        assert "W102" in got     # begin produced, never consumed
        assert "W103" in got     # submit consumed, never produced
        w103 = {f.symbol for f in fs if f.code == "W103"}
        # "submit" is unmatched in the LINK group even though HostOp
        # also registers the value — the registries do not cross-talk.
        assert "submit" in w103

    def test_link_op_group_clean_with_constants(self, tmp_path):
        root = write_tree(tmp_path, {
            "symmetry_tpu_torch/protocol/keys.py": (
                KEYS_PY + '\n\n'
                'class LinkOp:\n'
                '    BEGIN = "begin"\n'),
            "symmetry_tpu_torch/engine/disagg/net.py": (
                'from symmetry_tpu_torch.protocol.keys import LinkOp\n'
                'async def send(link):\n'
                '    await link.send({"op": LinkOp.BEGIN})\n'),
            "symmetry_tpu_torch/engine/disagg/node.py": (
                'from symmetry_tpu_torch.protocol.keys import LinkOp\n'
                'def pump(header):\n'
                '    op = header.get("op")\n'
                '    if op == LinkOp.BEGIN:\n'
                '        return header\n'),
        })
        assert [f for f in run(root) if f.checker == "wire-contract"] \
            == []

    def test_real_link_registry_fully_covered(self):
        """Registry-coverage pin on the REAL repo: every LinkOp constant
        is BOTH produced (a `{"op": LinkOp.X}` dict display) and
        consumed (a compare/membership against LinkOp.X) somewhere in
        the link group — an op that loses either side fails here before
        it strands a handoff on the wire."""
        import ast

        from symmetry_tpu_torch.protocol.keys import LINK_OPS, LinkOp

        def link_attrs(node):
            for sub in ast.walk(node):
                if isinstance(sub, ast.Attribute) and \
                        isinstance(sub.value, ast.Name) and \
                        sub.value.id == "LinkOp":
                    yield sub.attr

        produced: set[str] = set()
        consumed: set[str] = set()
        for rel in ("symmetry_tpu_torch/engine/disagg/net.py",
                    "symmetry_tpu_torch/engine/disagg/node.py"):
            with open(os.path.join(REPO, rel), encoding="utf-8") as fh:
                tree = ast.parse(fh.read())
            for node in ast.walk(tree):
                if isinstance(node, ast.Dict):
                    for k, v in zip(node.keys, node.values):
                        if (isinstance(k, ast.Constant)
                                and k.value == "op"):
                            produced.update(link_attrs(v))
                elif isinstance(node, ast.Compare):
                    consumed.update(link_attrs(node))
        names = {k for k in vars(LinkOp) if not k.startswith("_")}
        assert produced >= names, \
            f"LinkOp constants never produced: {names - produced}"
        assert consumed >= names, \
            f"LinkOp constants never consumed: {names - consumed}"
        assert len(LINK_OPS) == len(names), \
            "duplicate LinkOp values would alias wire ops"

    def test_nonexistent_registry_attribute_flags(self, tmp_path):
        # HostOp.EVNT (typo'd CONSTANT, not value) must flag, not vanish
        # from the consumed set: at runtime it is an AttributeError on a
        # rarely-taken dispatch arm.
        root = write_tree(tmp_path, {
            "symmetry_tpu_torch/protocol/keys.py": KEYS_PY,
            "symmetry_tpu_torch/engine/host.py": (
                'from symmetry_tpu_torch.protocol.keys import HostOp\n'
                'def emit(w):\n'
                '    w({"op": HostOp.EVENT})\n'),
            "symmetry_tpu_torch/provider/backends/tpu_native.py": (
                'from symmetry_tpu_torch.protocol.keys import HostOp\n'
                'def pump(msg):\n'
                '    op = msg.get("op")\n'
                '    if op == HostOp.EVNT:\n'
                '        return msg\n'
                '    if op == HostOp.EVENT:\n'
                '        return msg\n'),
        })
        fs = run(root)
        w104 = [f for f in fs if f.code == "W104"]
        assert [f.symbol for f in w104] == ["HostOp.EVNT"]

    def test_subscript_consumer_shape_recognized(self, tmp_path):
        # `msg["op"] == HostOp.X` is a consumer too — missing it would
        # false-W102 the producer of a perfectly consumed op.
        root = write_tree(tmp_path, {
            "symmetry_tpu_torch/protocol/keys.py": KEYS_PY,
            "symmetry_tpu_torch/engine/host.py": (
                'from symmetry_tpu_torch.protocol.keys import HostOp\n'
                'def emit(w):\n'
                '    w({"op": HostOp.EVENT})\n'),
            "symmetry_tpu_torch/provider/backends/tpu_native.py": (
                'from symmetry_tpu_torch.protocol.keys import HostOp\n'
                'def pump(msg):\n'
                '    if msg["op"] == HostOp.EVENT:\n'
                '        return msg\n'),
        })
        assert run(root) == []

    def test_message_key_send_without_handler(self, tmp_path):
        root = write_tree(tmp_path, {
            "symmetry_tpu_torch/protocol/keys.py": KEYS_PY,
            "symmetry_tpu_torch/provider/provider.py": (
                'from symmetry_tpu_torch.protocol.keys import MessageKey\n'
                'async def serve(peer, msg):\n'
                '    if msg.key == MessageKey.PING:\n'
                '        await peer.send(MessageKey.PONG)\n'),
            # nobody handles pong, nobody sends ping
        })
        got = codes(run(root))
        assert "W106" in got and "W107" in got


# -------------------------------------------------------------- concurrency


class TestConcurrency:
    def test_blocking_call_in_async_flags(self, tmp_path):
        root = write_tree(tmp_path, {
            "symmetry_tpu_torch/provider/p.py": (
                'import time\n'
                'async def relay():\n'
                '    time.sleep(1.0)\n'),
        })
        fs = run(root)
        assert codes(fs) == {"C201"}

    def test_async_sleep_and_executor_helper_clean(self, tmp_path):
        root = write_tree(tmp_path, {
            "symmetry_tpu_torch/provider/p.py": (
                'import asyncio, time\n'
                'async def relay():\n'
                '    await asyncio.sleep(1.0)\n'
                '    def build():\n'
                '        time.sleep(0.1)  # runs in a thread, allowed\n'
                '    await asyncio.to_thread(build)\n'),
        })
        assert run(root) == []

    def test_cross_thread_mutation_without_lock_flags(self, tmp_path):
        root = write_tree(tmp_path, {
            "symmetry_tpu_torch/engine/s.py": (
                'import threading\n'
                'class Loop:\n'
                '    def __init__(self):\n'
                '        self.count = 0\n'
                '    def start(self):\n'
                '        threading.Thread(target=self._run).start()\n'
                '    def _run(self):\n'
                '        self.count += 1\n'
                '    def submit(self):\n'
                '        self.count += 1\n'),
        })
        fs = run(root)
        assert codes(fs) == {"C202"}
        assert fs[0].symbol == "Loop.count"

    def test_locked_mutation_clean(self, tmp_path):
        root = write_tree(tmp_path, {
            "symmetry_tpu_torch/engine/s.py": (
                'import threading\n'
                'class Loop:\n'
                '    def __init__(self):\n'
                '        self.count = 0\n'
                '        self._lock = threading.Lock()\n'
                '    def start(self):\n'
                '        threading.Thread(target=self._run).start()\n'
                '    def _run(self):\n'
                '        with self._lock:\n'
                '            self.count += 1\n'
                '    def submit(self):\n'
                '        with self._lock:\n'
                '            self.count += 1\n'),
        })
        assert run(root) == []

    def test_escaped_closure_counts_as_thread_context(self, tmp_path):
        # The exact shape of the engine-host adopt-thunk race this
        # checker caught for real: a local def handed to other
        # machinery mutates the same counter the pipe thread does.
        root = write_tree(tmp_path, {
            "symmetry_tpu_torch/engine/h.py": (
                'class Host:\n'
                '    def __init__(self, sched):\n'
                '        self.stats = {"errors": 0}\n'
                '        self._sched = sched\n'
                '    def handle(self, msg):\n'
                '        def adopt(req):\n'
                '            self.stats["errors"] += 1\n'
                '        self._sched.submit(adopt)\n'
                '        self.stats["errors"] += 1\n'),
        })
        fs = run(root)
        assert codes(fs) == {"C202"}
        assert "stats['errors']" in fs[0].symbol

    def test_different_locks_do_not_exclude(self, tmp_path):
        # Two sites each "locked" — but by DIFFERENT locks: still a race.
        root = write_tree(tmp_path, {
            "symmetry_tpu_torch/engine/s.py": (
                'import threading\n'
                'class Loop:\n'
                '    def start(self):\n'
                '        threading.Thread(target=self._run).start()\n'
                '    def _run(self):\n'
                '        with self._stats_lock:\n'
                '            self.count += 1\n'
                '    def submit(self):\n'
                '        with self._io_lock:\n'
                '            self.count += 1\n'),
        })
        fs = run(root)
        assert codes(fs) == {"C202"}
        # the diagnostic must not claim "unlocked" — both sites hold a
        # lock, just not the same one
        assert "no common lock" in fs[0].message

    def test_mutator_method_calls_are_mutations(self, tmp_path):
        # The .update()/.pop() shape of the same race class — invisible
        # to Assign/AugAssign extraction, so tracked explicitly.
        root = write_tree(tmp_path, {
            "symmetry_tpu_torch/engine/s.py": (
                'import threading\n'
                'class Loop:\n'
                '    def start(self):\n'
                '        threading.Thread(target=self._run).start()\n'
                '    def _run(self):\n'
                '        self.stats.update(done=1)\n'
                '    def submit(self, k):\n'
                '        self.stats.pop(k, None)\n'),
        })
        fs = run(root)
        assert codes(fs) == {"C202"}
        assert fs[0].symbol == "Loop.stats"

    def test_result_with_timeout_still_blocks(self, tmp_path):
        # Future.result(timeout=30) blocks the loop for up to 30 s —
        # the timeout kwarg must not exempt it.
        root = write_tree(tmp_path, {
            "symmetry_tpu_torch/provider/p.py": (
                'async def relay(fut):\n'
                '    return fut.result(timeout=30)\n'),
        })
        assert codes(run(root)) == {"C201"}

    def test_whole_dict_mutator_collides_with_key_writes(self, tmp_path):
        # thread A rewrites the dict wholesale, thread B bumps one key:
        # different granularities, same race.
        root = write_tree(tmp_path, {
            "symmetry_tpu_torch/engine/s.py": (
                'import threading\n'
                'class Loop:\n'
                '    def start(self):\n'
                '        threading.Thread(target=self._run).start()\n'
                '    def _run(self):\n'
                '        self.stats.update(requests=0)\n'
                '    def submit(self):\n'
                '        self.stats["requests"] += 1\n'),
        })
        fs = run(root)
        assert codes(fs) == {"C202"}
        assert "stats['requests']" in fs[0].symbol

    def test_unbounded_cross_thread_queue_flags(self, tmp_path):
        # C203 TP: main-thread producers, worker-thread consumer, no
        # maxsize — the slow-consumer OOM shape.
        root = write_tree(tmp_path, {
            "symmetry_tpu_torch/engine/s.py": (
                'import queue, threading\n'
                'class Loop:\n'
                '    def __init__(self):\n'
                '        self.inbox = queue.Queue()\n'
                '    def start(self):\n'
                '        threading.Thread(target=self._run).start()\n'
                '    def _run(self):\n'
                '        while True:\n'
                '            self.inbox.get()\n'
                '    def submit(self, item):\n'
                '        self.inbox.put(item)\n'),
        })
        fs = run(root)
        assert codes(fs) == {"C203"}
        assert fs[0].symbol == "Loop.inbox"
        assert "unbounded" in fs[0].message

    def test_bounded_emit_queue_handoff_clean(self, tmp_path):
        # C203 TN: the scheduler's emit-worker shape — a bounded queue
        # (nonzero maxsize, even computed) between the dispatch thread
        # and the emit worker, sentinel None shutdown included. The
        # blocking put IS the designed backpressure; nothing to flag.
        root = write_tree(tmp_path, {
            "symmetry_tpu_torch/engine/s.py": (
                'import queue, threading\n'
                'class Sched:\n'
                '    def __init__(self, emit_queue_blocks=8):\n'
                '        self._emit_queue = queue.Queue(\n'
                '            maxsize=max(1, int(emit_queue_blocks)))\n'
                '    def start(self):\n'
                '        threading.Thread(\n'
                '            target=self._emit_worker_run).start()\n'
                '        threading.Thread(target=self._run).start()\n'
                '    def _run(self):\n'
                '        self._emit_queue.put(["job"])\n'
                '        self._emit_queue.put(None)\n'
                '    def _emit_worker_run(self):\n'
                '        while True:\n'
                '            jobs = self._emit_queue.get()\n'
                '            if jobs is None:\n'
                '                return\n'),
        })
        assert run(root) == []

    def test_single_thread_and_asyncio_queues_clean(self, tmp_path):
        # C203 TN ×2: an unbounded queue both produced and consumed by
        # the SAME worker thread (a private work list — no cross-thread
        # backlog), and an asyncio.Queue (loop-internal flow control,
        # out of scope for a thread checker).
        root = write_tree(tmp_path, {
            "symmetry_tpu_torch/engine/s.py": (
                'import queue, threading\n'
                'class Loop:\n'
                '    def __init__(self):\n'
                '        self.todo = queue.Queue()\n'
                '    def start(self):\n'
                '        threading.Thread(target=self._run).start()\n'
                '    def _run(self):\n'
                '        self.todo.put(1)\n'
                '        self.todo.get()\n'),
            "symmetry_tpu_torch/provider/p.py": (
                'import asyncio\n'
                'class Relay:\n'
                '    def __init__(self):\n'
                '        self.frames = asyncio.Queue()\n'
                '    def handle(self):\n'
                '        self.frames.put_nowait(b"x")\n'
                '    async def pump(self):\n'
                '        return await self.frames.get()\n'),
        })
        assert run(root) == []

    def test_simplequeue_cross_thread_flags(self, tmp_path):
        # SimpleQueue cannot be bounded at all — crossing threads, it
        # is always the C203 shape.
        root = write_tree(tmp_path, {
            "symmetry_tpu_torch/engine/s.py": (
                'import queue, threading\n'
                'class Loop:\n'
                '    def __init__(self):\n'
                '        self.out = queue.SimpleQueue()\n'
                '    def start(self):\n'
                '        threading.Thread(target=self._run).start()\n'
                '    def _run(self):\n'
                '        self.out.put(1)\n'
                '    def drain(self):\n'
                '        return self.out.get()\n'),
        })
        fs = run(root)
        assert codes(fs) == {"C203"}

    def test_nested_async_blocking_reported_once(self, tmp_path):
        root = write_tree(tmp_path, {
            "symmetry_tpu_torch/network/n.py": (
                'import time\n'
                'async def dial():\n'
                '    async def burst():\n'
                '        time.sleep(0.1)\n'
                '    await burst()\n'),
        })
        fs = run(root)
        assert [f.symbol for f in fs] == ["burst:time.sleep"]

    def test_per_key_granularity_is_not_a_race(self, tmp_path):
        # engine thread owns metrics["steps"], callers own
        # metrics["requests"]: distinct GIL-atomic keys, no finding.
        root = write_tree(tmp_path, {
            "symmetry_tpu_torch/engine/s.py": (
                'import threading\n'
                'class Loop:\n'
                '    def __init__(self):\n'
                '        self.metrics = {"requests": 0, "steps": 0}\n'
                '    def start(self):\n'
                '        threading.Thread(target=self._run).start()\n'
                '    def _run(self):\n'
                '        self.metrics["steps"] += 1\n'
                '    def submit(self):\n'
                '        self.metrics["requests"] += 1\n'),
        })
        assert run(root) == []


# --------------------------------------------------------- recompile-hazard


class TestRecompileHazard:
    def test_value_branch_and_int_flag(self, tmp_path):
        root = write_tree(tmp_path, {
            "symmetry_tpu_torch/ops/k.py": (
                'import functools, jax\n'
                '@functools.partial(jax.jit, static_argnames=("bk",))\n'
                'def f(x, n, bk):\n'
                '    if n > 0:\n'
                '        x = x + 1\n'
                '    m = int(n)\n'
                '    return x, m\n'),
        })
        got = codes(run(root))
        assert got == {"R301", "R302"}

    def test_shape_branch_and_static_arg_clean(self, tmp_path):
        root = write_tree(tmp_path, {
            "symmetry_tpu_torch/ops/k.py": (
                'import functools, jax\n'
                '@functools.partial(jax.jit, static_argnames=("bk",))\n'
                'def f(x, bk, w=None):\n'
                '    if x.shape[0] > 1 and bk > 8:\n'
                '        x = x * 2\n'
                '    if w is not None:\n'
                '        x = x + w\n'
                '    n = int(x.shape[1])\n'
                '    return x, n\n'),
        })
        assert run(root) == []

    def test_call_site_jit_wrapping_and_host_pull(self, tmp_path):
        # the engine's `self._p = jax.jit(prefill, donate_argnums=…)`
        # shape: the wrapped def is found by name, np.asarray flags
        root = write_tree(tmp_path, {
            "symmetry_tpu_torch/engine/engine.py": (
                'import jax\n'
                'import numpy as np\n'
                'class E:\n'
                '    def build(self):\n'
                '        def prefill(tokens, params):\n'
                '            host = np.asarray(tokens)\n'
                '            return host\n'
                '        self._prefill = jax.jit(prefill,'
                ' donate_argnums=(0,))\n'),
        })
        fs = run(root)
        assert codes(fs) == {"R303"}
        assert fs[0].symbol.startswith("prefill:")

    def test_same_named_defs_are_each_analyzed(self, tmp_path):
        # Two builders each jit-wrap their own nested `def step`: a
        # name-keyed registry would analyze the first and silently
        # skip the hazard in the second.
        root = write_tree(tmp_path, {
            "symmetry_tpu_torch/engine/engine.py": (
                'import jax\n'
                'class A:\n'
                '    def build(self):\n'
                '        def step(x):\n'
                '            return x\n'
                '        self._s = jax.jit(step)\n'
                'class B:\n'
                '    def build(self):\n'
                '        def step(x, n):\n'
                '            return x, int(n)\n'
                '        self._s = jax.jit(step)\n'),
        })
        fs = run(root)
        assert codes(fs) == {"R301"}


# --------------------------------------------------------------- fault-seam


class TestFaultSeam:
    def test_armed_without_guard_flags(self, tmp_path):
        root = write_tree(tmp_path, {
            "tests/test_chaos.py": (
                'CFG = {"faults": {"host.pipe_wrote": "crash@nth=2"}}\n'),
            "symmetry_tpu_torch/utils/faults.py": (
                'class FaultInjector:\n'
                '    pass\n'),
        })
        fs = run(root)
        assert codes(fs) == {"S401"}
        assert fs[0].symbol == "host.pipe_wrote"

    def test_guard_without_arming_flags(self, tmp_path):
        root = write_tree(tmp_path, {
            "symmetry_tpu_torch/engine/host.py": (
                'from symmetry_tpu_torch.utils.faults import FAULTS\n'
                'def write(frame):\n'
                '    if FAULTS.enabled and'
                ' FAULTS.point("host.pipe_write"):\n'
                '        return\n'),
        })
        fs = run(root)
        assert codes(fs) == {"S402"}
        assert fs[0].symbol == "host.pipe_write"

    def test_matched_pair_and_env_string_clean(self, tmp_path):
        root = write_tree(tmp_path, {
            "symmetry_tpu_torch/engine/host.py": (
                'from symmetry_tpu_torch.utils.faults import FAULTS\n'
                'def write(frame):\n'
                '    if FAULTS.enabled and'
                ' FAULTS.point("host.pipe_write"):\n'
                '        return\n'),
            "tests/test_chaos.py": (
                'SPEC = "host.pipe_write=crash@nth=2"\n'),
        })
        assert run(root) == []

    def test_self_contained_injector_test_exempt(self, tmp_path):
        root = write_tree(tmp_path, {
            "tests/test_faults.py": (
                'from symmetry_tpu_torch.utils.faults import FAULTS\n'
                'def test_roundtrip():\n'
                '    FAULTS.load({"x.y": "error"})\n'
                '    assert FAULTS.point("x.y") is False\n'),
        })
        assert run(root) == []


# -------------------------------------------------------- metric-names


METRICS_PY = '''\
class MetricName:
    REQS = "sym_t_requests_total"
    TOKS = "sym_t_tokens_total"
    DEAD = "sym_t_never_emitted_total"
'''


class TestMetricNames:
    def test_raw_literal_unregistered_and_dead_flag(self, tmp_path):
        root = write_tree(tmp_path, {
            "symmetry_tpu_torch/utils/metrics.py": METRICS_PY,
            "symmetry_tpu_torch/provider/provider.py": (
                'from symmetry_tpu_torch.utils.metrics import METRICS, MetricName\n'
                'def init():\n'
                # registered name spelled raw (M101)…
                '    METRICS.counter("sym_t_requests_total")\n'
                # …a name the registry never heard of (M102)…
                '    METRICS.gauge("sym_t_typo_total")\n'
                # …a nonexistent registry attribute (M102)…
                '    METRICS.histogram(MetricName.TYPO)\n'
                # …and one clean emission
                '    METRICS.counter(MetricName.TOKS)\n'),
        })
        fs = [f for f in run(root) if f.checker == "metric-names"]
        got = codes(fs)
        assert got == {"M101", "M102", "M103"}
        assert {f.symbol for f in fs if f.code == "M101"} == \
            {"sym_t_requests_total"}
        assert {f.symbol for f in fs if f.code == "M102"} == \
            {"sym_t_typo_total", "MetricName.TYPO"}
        # DEAD registered but never emitted; REQS only emitted raw —
        # raw emission still counts as emitted, so it is not M103.
        assert {f.symbol for f in fs if f.code == "M103"} == \
            {"sym_t_never_emitted_total"}
        # M103 anchors at the registry assignment, not an emitter
        (dead,) = [f for f in fs if f.code == "M103"]
        assert dead.path == "symmetry_tpu_torch/utils/metrics.py"

    def test_constant_emissions_clean(self, tmp_path):
        root = write_tree(tmp_path, {
            "symmetry_tpu_torch/utils/metrics.py": (
                'class MetricName:\n'
                '    REQS = "sym_t_requests_total"\n'
                '    LAT = "sym_t_lat_seconds"\n'),
            "symmetry_tpu_torch/engine/scheduler.py": (
                'from symmetry_tpu_torch.utils.metrics import METRICS, MetricName\n'
                'def init(self):\n'
                '    self._m = METRICS.counter(MetricName.REQS, "reqs")\n'
                '    METRICS.histogram(MetricName.LAT, labels=("kind",))\n'),
        })
        assert [f for f in run(root) if f.checker == "metric-names"] == []

    def test_tests_and_other_receivers_out_of_scope(self, tmp_path):
        root = write_tree(tmp_path, {
            "symmetry_tpu_torch/utils/metrics.py": (
                'class MetricName:\n'
                '    REQS = "sym_t_requests_total"\n'),
            # tests pin names as raw literals deliberately — not scanned
            "tests/test_metrics.py": (
                'def test_x(METRICS):\n'
                '    METRICS.counter("sym_t_whatever_total")\n'),
            # a Tracer's .counter/.histogram is NOT a registry emission
            "symmetry_tpu_torch/engine/scheduler.py": (
                'from symmetry_tpu_torch.utils.metrics import METRICS, MetricName\n'
                'def f(self):\n'
                '    self.tracer.counter("occupancy", 1)\n'
                '    self.tracer.histogram("x_s")\n'
                '    METRICS.counter(MetricName.REQS)\n'),
        })
        assert [f for f in run(root) if f.checker == "metric-names"] == []

    def test_real_registry_fully_emitted(self):
        # The real repo: every MetricName constant must have a live
        # emission site and no emitter may bypass the registry — the
        # CI-gate contract, pinned here independently of the baseline.
        fs = [f for f in run(REPO) if f.checker == "metric-names"]
        assert fs == [], [f.render() for f in fs]


# ----------------------------------------------------- baseline + runner


class TestBaselineAndRunner:
    MISMATCH = {
        "symmetry_tpu_torch/protocol/keys.py": KEYS_PY,
        "symmetry_tpu_torch/engine/host.py": (
            'from symmetry_tpu_torch.protocol.keys import HostOp\n'
            'def emit(w):\n'
            '    w({"op": HostOp.SUBMIT})\n'),
    }

    def test_baseline_suppresses_by_fingerprint(self, tmp_path):
        root = write_tree(tmp_path, self.MISMATCH)
        fs = run(root)
        assert fs and all(not f.baselined for f in fs)
        bl = Baseline([{"fingerprint": f.fingerprint, "reason": "test"}
                       for f in fs])
        fs2 = run(root, baseline=bl)
        assert fs2 and all(f.baselined for f in fs2)
        assert bl.unused() == []

    def test_baseline_requires_reasons(self, tmp_path):
        path = tmp_path / "bl.json"
        path.write_text(json.dumps(
            {"suppressions": [{"fingerprint": "X:y:z"}]}))
        with pytest.raises(ValueError, match="no\\s+reason"):
            Baseline.load(str(path))

    def _symlint(self, *args):
        return subprocess.run(
            [sys.executable, "-m", "symmetry_tpu_torch.analysis", *args],
            capture_output=True, text=True, cwd=REPO)

    def test_runner_exits_nonzero_on_seeded_wire_mismatch(self, tmp_path):
        # The CI-gate contract: a produced-but-never-consumed op must
        # fail the step.
        root = write_tree(tmp_path, self.MISMATCH)
        r = self._symlint("--root", root)
        assert r.returncode == 1
        assert "W102" in r.stdout and "submit" in r.stdout

    def test_runner_json_schema(self, tmp_path):
        root = write_tree(tmp_path, self.MISMATCH)
        r = self._symlint("--root", root, "--json")
        assert r.returncode == 1
        report = json.loads(r.stdout)
        assert report["version"] == 1
        assert set(report["counts"]) == {"total", "new", "baselined"}
        assert report["counts"]["new"] == len(report["findings"]) > 0
        f = report["findings"][0]
        assert set(f) == {"checker", "code", "path", "line", "message",
                          "symbol", "fingerprint", "baselined"}
        assert f["fingerprint"].startswith(f["code"] + ":")
        assert [s.name for s in ALL_CHECKERS] == report["checkers"]

    def test_runner_checker_filter_and_clean_exit(self, tmp_path):
        root = write_tree(tmp_path, self.MISMATCH)
        # the mismatch is wire-only: filtering to fault-seam is clean
        r = self._symlint("--root", root, "--checker", "fault-seam")
        assert r.returncode == 0, r.stdout + r.stderr

    def test_path_filter_keeps_cross_file_context(self, tmp_path):
        # Positional paths filter the REPORT, not the scan: the clean
        # consumer file exits 0 even though the mismatch lives in the
        # producer file — and naming the producer still fails.
        root = write_tree(tmp_path, {
            **self.MISMATCH,
            "symmetry_tpu_torch/provider/backends/tpu_native.py": (
                'from symmetry_tpu_torch.protocol.keys import HostOp\n'
                'def pump(msg):\n'
                '    op = msg.get("op")\n'
                '    if op == HostOp.EVENT:\n'
                '        return msg\n'),
        })
        r = self._symlint("--root", root,
                          "symmetry_tpu_torch/protocol/keys.py")
        assert r.returncode == 0, r.stdout + r.stderr
        r = self._symlint("--root", root, "symmetry_tpu_torch/engine/host.py")
        assert r.returncode == 1 and "W102" in r.stdout
        # a typo'd filter path is a broken invocation, not a clean run
        r = self._symlint("--root", root, "no/such/file.py")
        assert r.returncode == 2 and "matched no scanned file" in r.stderr

    def test_unused_baseline_entry_reported_and_strict(self, tmp_path):
        root = write_tree(tmp_path, {
            "symmetry_tpu_torch/engine/empty.py": "X = 1\n"})
        bl = tmp_path / "bl.json"
        bl.write_text(json.dumps({"suppressions": [
            {"fingerprint": "W102:gone.py:ghost", "reason": "stale"}]}))
        r = self._symlint("--root", root, "--baseline", str(bl))
        assert r.returncode == 0 and "matched nothing" in r.stderr
        r = self._symlint("--root", root, "--baseline", str(bl),
                          "--strict-baseline")
        assert r.returncode == 1

    def test_checker_filter_does_not_stale_other_checkers_entries(
            self, tmp_path):
        # A C202 suppression is not stale just because this run was
        # wire-contract-only — pruning on that advice would break the
        # next full run.
        root = write_tree(tmp_path, {
            "symmetry_tpu_torch/engine/empty.py": "X = 1\n"})
        bl = tmp_path / "bl.json"
        bl.write_text(json.dumps({"suppressions": [
            {"fingerprint": "C202:a.py:Cls.attr", "reason": "owned"}]}))
        r = self._symlint("--root", root, "--baseline", str(bl),
                          "--checker", "wire-contract",
                          "--strict-baseline")
        assert r.returncode == 0 and "matched nothing" not in r.stderr
        # …but the same entry IS stale when its checker runs
        r = self._symlint("--root", root, "--baseline", str(bl),
                          "--checker", "concurrency", "--strict-baseline")
        assert r.returncode == 1 and "matched nothing" in r.stderr


# ------------------------------------------------------------- self-test


BASELINE = os.path.join(REPO, "symmetry_tpu_torch", "analysis",
                        "baseline.json")


class TestRepoClean:
    def test_repo_runs_clean_modulo_baseline(self):
        """The acceptance gate, from the inside: zero non-baselined
        findings on the port's tree, and no stale baseline entries."""
        bl = Baseline.load(BASELINE)
        findings = run(REPO, baseline=bl)
        fresh = [f for f in findings if not f.baselined]
        assert fresh == [], "\n".join(f.render() for f in fresh)
        assert bl.unused() == [], (
            "stale baseline entries — prune "
            "symmetry_tpu_torch/analysis/baseline.json")

    def test_findings_are_the_ports_and_justified(self):
        """Every finding is in the port's package, and every baseline
        entry names a port file and carries a reason of its own."""
        findings = run(REPO)
        assert findings and all(
            f.path.startswith("symmetry_tpu_torch/")
            or f.path.startswith(("tests/", "tools/")) for f in findings)
        assert not [f for f in findings if f.path.startswith(
            "symmetry_tpu/")]
        with open(BASELINE, encoding="utf-8") as fh:
            entries = json.load(fh)["suppressions"]
        with open(os.path.join(REPO, "tools", "symlint_baseline.json"),
                  encoding="utf-8") as fh:
            jax_reasons = {e["reason"] for e in json.load(fh)[
                "suppressions"]}
        for e in entries:
            assert e["fingerprint"].split(":")[1].startswith(
                "symmetry_tpu_torch/"), e
            assert e["reason"] not in jax_reasons, e["fingerprint"]

    def test_runner_strict_baseline_exits_zero(self):
        r = subprocess.run(
            [sys.executable, "-m", "symmetry_tpu_torch.analysis",
             "--strict-baseline"], capture_output=True, text=True,
            cwd=REPO)
        assert r.returncode == 0, r.stdout + r.stderr
        assert "0 new finding(s)" in r.stderr

    def test_host_op_registry_matches_protocol_docstring_ops(self):
        # The registry the wire checker pivots on must cover the ops the
        # engine host actually dispatches (drift here would quietly
        # weaken every W-code).
        from symmetry_tpu_torch.protocol.keys import HOST_OPS
        for op in ("submit", "adopt", "cancel", "clock", "trace",
                   "stats", "shutdown", "ready", "event", "events",
                   "handoff"):
            assert op in HOST_OPS


class TestHostStatsLockRegression:
    """Regression for the two real C202 findings symlint surfaced:
    EngineHost.handoff_stats / adopt_stats were mutated from the
    pipe-reader thread AND the engine thread without a lock. The fix
    takes _wlock around every mutation; this hammers the handoff path
    from two threads and requires exact counts."""

    def test_emit_handoff_counters_are_exact_under_contention(self):
        from symmetry_tpu_torch.engine.host import EngineHost

        host = EngineHost(None)

        class _Eng:
            kv_quant = False
            prefix_block = 8

        host._engine = _Eng()
        host._write = lambda obj, events=0: None  # no real pipe
        n, threads = 200, 4
        old = sys.getswitchinterval()
        sys.setswitchinterval(1e-5)
        try:
            def hammer():
                for i in range(n):
                    host._emit_handoff(f"r{i}", [1, 2, 3], 0, None)

            ts = [threading.Thread(target=hammer) for _ in range(threads)]
            for t in ts:
                t.start()
            for t in ts:
                t.join()
        finally:
            sys.setswitchinterval(old)
        assert host.handoff_stats["frames"] == n * threads
        assert host.handoff_stats["routing_only"] == n * threads


# ------------------------------------------------- dataflow engine (CFG)


class _Probe:
    """Trivial semantics: the state is the frozenset of statement lines
    a path executed; at_exit records (exceptional, lines). Pins the
    CFG's edge structure without any checker logic in the way."""

    def __init__(self, prune=None):
        self.exits = []
        self.prune = prune  # (test_line, taken) branches to cut

    def initial(self):
        return frozenset()

    def transfer(self, node, state):
        line = getattr(node.stmt, "lineno", None)
        post = state | {line} if line is not None else state
        return post, post, ()

    def on_branch(self, test, state, taken):
        if self.prune and (getattr(test, "lineno", None), taken) \
                in self.prune:
            return None
        return state

    def at_exit(self, state, exceptional):
        self.exits.append((exceptional, state))
        return ()


def _analyze_probe(src, **kw):
    import ast as _ast

    from symmetry_tpu_torch.analysis.dataflow import analyze

    func = _ast.parse(src).body[0]
    probe = _Probe(**kw)
    analyze(func, probe)
    return probe


class TestDataflowEngine:
    def test_raising_call_reaches_both_exits(self):
        p = _analyze_probe("def f():\n"
                           "    boom()\n")
        kinds = {e for e, _ in p.exits}
        assert kinds == {False, True}

    def test_finally_runs_on_normal_and_exception_paths(self):
        p = _analyze_probe("def f():\n"
                           "    try:\n"
                           "        boom()\n"        # line 3
                           "    finally:\n"
                           "        note = 1\n")     # line 5
        # EVERY exit — the fallthrough and the unwind — saw the
        # finally body (cloned per continuation, not joined).
        assert p.exits and all(5 in lines for _, lines in p.exits)
        assert {e for e, _ in p.exits} == {False, True}

    def test_except_handler_catches_and_continues(self):
        p = _analyze_probe("def f():\n"
                           "    try:\n"
                           "        boom()\n"
                           "    except Exception:\n"
                           "        cleanup = 1\n"   # line 5
                           "    tail = 1\n")         # line 6
        # catch-all: no exceptional exit escapes the function
        assert {e for e, _ in p.exits} == {False}
        # some path took handler → tail
        assert any({5, 6} <= lines for _, lines in p.exits)

    def test_narrow_handler_propagates_past(self):
        p = _analyze_probe("def f():\n"
                           "    try:\n"
                           "        boom()\n"
                           "    except KeyError:\n"
                           "        pass\n")
        # the exception may match no handler and keep unwinding
        assert {e for e, _ in p.exits} == {False, True}

    def test_early_return_skips_tail(self):
        p = _analyze_probe("def f(a):\n"
                           "    if a:\n"
                           "        return 1\n"      # line 3
                           "    tail = 1\n")         # line 4
        normal = [lines for e, lines in p.exits if not e]
        assert any(3 in lines and 4 not in lines for lines in normal)
        assert any(4 in lines and 3 not in lines for lines in normal)

    def test_branch_pruning_cuts_paths(self):
        p = _analyze_probe("def f(a):\n"
                           "    if a:\n"             # test line 2
                           "        dead = 1\n"      # line 3
                           "    tail = 1\n",
                           prune={(2, True)})
        assert p.exits
        assert all(3 not in lines for _, lines in p.exits)

    def test_with_and_while_edges(self):
        p = _analyze_probe("def f(ctx, flag):\n"
                           "    with ctx():\n"
                           "        boom()\n"
                           "    while flag:\n"
                           "        flag = step()\n"
                           "    done = 1\n")         # line 6
        kinds = {e for e, _ in p.exits}
        assert kinds == {False, True}   # body raise escapes the with
        assert any(6 in lines for e, lines in p.exits if not e)

    def test_store_subscript_is_not_an_exception_edge(self):
        # `d[k] = v` cannot realistically raise — fabricating an
        # unwind edge out of every container store would drown the
        # lifecycle checker in phantom leak paths (the scheduler's
        # hit_units shape).
        p = _analyze_probe("def f(d, k, v):\n"
                           "    d[k] = v\n")
        assert {e for e, _ in p.exits} == {False}
        p = _analyze_probe("def f(d, k):\n"
                           "    v = d[k]\n")         # a Load CAN raise
        assert {e for e, _ in p.exits} == {False, True}


# ----------------------------------------------------- lifecycle (L4xx)


def lifecycle_codes(root) -> set[str]:
    return {f.code for f in run(root) if f.checker == "lifecycle"}


class TestLifecycle:
    def test_exception_path_leak_flags_L402(self, tmp_path):
        # The PR-12 shape: device work between plan_insert and the
        # commit/abort pair, outside any try — the unwind leaks the pin.
        root = write_tree(tmp_path, {
            "symmetry_tpu_torch/engine.py": (
                "def store(idx, tokens, dev):\n"
                "    plan = idx.plan_insert(tokens)\n"
                "    if plan is None:\n"
                "        return\n"
                "    dev.scatter(plan.new_ids)\n"
                "    plan.commit()\n"),
        })
        assert "L402" in lifecycle_codes(root)

    def test_abort_on_exception_path_clean(self, tmp_path):
        root = write_tree(tmp_path, {
            "symmetry_tpu_torch/engine.py": (
                "def store(idx, tokens, dev):\n"
                "    plan = idx.plan_insert(tokens)\n"
                "    if plan is None:\n"
                "        return\n"
                "    try:\n"
                "        dev.scatter(plan.new_ids)\n"
                "    except Exception:\n"
                "        plan.abort()\n"
                "        raise\n"
                "    plan.commit()\n"),
        })
        assert lifecycle_codes(root) == set()

    def test_release_in_finally_clean(self, tmp_path):
        root = write_tree(tmp_path, {
            "symmetry_tpu_torch/sched.py": (
                "def place(idx, t, eng):\n"
                "    hit = idx.lookup(t)\n"
                "    if hit is None:\n"
                "        return 0\n"
                "    try:\n"
                "        return eng.seed(hit.length)\n"
                "    finally:\n"
                "        hit.release()\n"),
        })
        assert lifecycle_codes(root) == set()

    def test_normal_path_leak_flags_L401(self, tmp_path):
        root = write_tree(tmp_path, {
            "symmetry_tpu_torch/sched.py": (
                "def peek(idx, t):\n"
                "    hit = idx.lookup(t)\n"
                "    if hit is not None:\n"
                "        log(hit.length)\n"
                "    return 1\n"),
        })
        assert "L401" in lifecycle_codes(root)

    def test_resume_journal_exception_leak_flags_L402(self, tmp_path):
        # The resume-journal protocol (PR 14): track() on admission must
        # release() on the exception edge too — a leaked entry is a
        # finished request the death paths would stamp forever.
        root = write_tree(tmp_path, {
            "symmetry_tpu_torch/backend.py": (
                "def serve(self, request_id, host):\n"
                "    entry = self._journal.track(request_id)\n"
                "    host.submit(request_id)\n"
                "    entry.release()\n"),
        })
        assert "L402" in lifecycle_codes(root)

    def test_resume_journal_release_in_finally_clean(self, tmp_path):
        root = write_tree(tmp_path, {
            "symmetry_tpu_torch/backend.py": (
                "def serve(self, request_id, host):\n"
                "    entry = self._journal.track(request_id)\n"
                "    try:\n"
                "        host.submit(request_id)\n"
                "        entry.note(3)\n"
                "    finally:\n"
                "        entry.release()\n"),
        })
        assert lifecycle_codes(root) == set()

    def test_resume_journal_hint_scopes_track(self, tmp_path):
        # `track` on a non-journal receiver is someone else's method —
        # the receiver hint keeps the spec from claiming it.
        root = write_tree(tmp_path, {
            "symmetry_tpu_torch/other.py": (
                "def follow(self, request_id):\n"
                "    t = self._watcher.track(request_id)\n"
                "    return t\n"),
        })
        assert lifecycle_codes(root) == set()

    def test_ledger_entry_leak_flags_L401(self, tmp_path):
        # The symledger protocol (PR 20): a tracked cost account that
        # no path finishes or releases never folds its device seconds —
        # conservation silently stops closing.
        root = write_tree(tmp_path, {
            "symmetry_tpu_torch/sched.py": (
                "def run(self, req):\n"
                "    entry = self.ledger.track(req.id)\n"
                "    if entry is not None:\n"
                "        entry.book_device('decode', 0.1)\n"
                "    return 1\n"),
        })
        assert "L401" in lifecycle_codes(root)

    def test_ledger_entry_finish_or_release_clean(self, tmp_path):
        # Either closer resolves the entry (both idempotent), and the
        # optional acquire means the None miss path needs no close.
        root = write_tree(tmp_path, {
            "symmetry_tpu_torch/sched.py": (
                "def run(self, req, handoff):\n"
                "    entry = self.ledger.track(req.id)\n"
                "    if entry is None:\n"
                "        return 0\n"
                "    try:\n"
                "        entry.book_device('decode', 0.1)\n"
                "    finally:\n"
                "        if handoff:\n"
                "            entry.release('handoff')\n"
                "        else:\n"
                "            entry.finish('stop')\n"
                "    return 1\n"),
        })
        assert lifecycle_codes(root) == set()

    def test_double_commit_flags_L403(self, tmp_path):
        root = write_tree(tmp_path, {
            "symmetry_tpu_torch/engine.py": (
                "def twice(idx, tokens):\n"
                "    plan = idx.plan_insert(tokens)\n"
                "    if plan is None:\n"
                "        return\n"
                "    plan.commit()\n"
                "    plan.commit()\n"),
        })
        assert "L403" in lifecycle_codes(root)

    def test_read_after_abort_flags_L404(self, tmp_path):
        root = write_tree(tmp_path, {
            "symmetry_tpu_torch/engine.py": (
                "def freed(idx, tokens):\n"
                "    plan = idx.plan_insert(tokens)\n"
                "    if plan is None:\n"
                "        return None\n"
                "    plan.abort()\n"
                "    return plan.new_ids\n"),
        })
        assert "L404" in lifecycle_codes(root)

    def test_none_check_before_release_is_not_a_use(self, tmp_path):
        # The scheduler's cleanup-handler idiom: a bare `hit is not
        # None` after a release on some path reads the NAME, not the
        # resource.
        root = write_tree(tmp_path, {
            "symmetry_tpu_torch/sched.py": (
                "def place(idx, t, eng):\n"
                "    hit = idx.lookup(t)\n"
                "    try:\n"
                "        if hit is not None:\n"
                "            eng.seed(hit.length)\n"
                "            hit.release()\n"
                "            hit = None\n"
                "    except Exception:\n"
                "        if hit is not None:\n"
                "            hit.release()\n"
                "        raise\n"),
        })
        assert lifecycle_codes(root) == set()

    def test_returning_an_attribute_is_not_a_transfer(self, tmp_path):
        # `return hit.length` READS the pin, it does not hand it off —
        # the leak must still be reported (regression: the escape walk
        # once matched the bare name inside the attribute chain).
        root = write_tree(tmp_path, {
            "symmetry_tpu_torch/sched.py": (
                "def depth(idx, t):\n"
                "    hit = idx.lookup(t)\n"
                "    if hit is None:\n"
                "        return 0\n"
                "    return hit.length\n"),
        })
        assert "L401" in lifecycle_codes(root)

    def test_conditional_release_in_finally_clean(self, tmp_path):
        # The standard guarded-cleanup idiom: narrowing must survive
        # inside the finally clone's exception continuation
        # (regression: the clone's branch edges were relabeled
        # exceptional, bypassing on_branch).
        root = write_tree(tmp_path, {
            "symmetry_tpu_torch/sched.py": (
                "def place(idx, t, eng):\n"
                "    hit = idx.lookup(t)\n"
                "    try:\n"
                "        eng.seed(t)\n"
                "    finally:\n"
                "        if hit is not None:\n"
                "            hit.release()\n"),
        })
        assert lifecycle_codes(root) == set()

    def test_ownership_transfer_ends_tracking(self, tmp_path):
        root = write_tree(tmp_path, {
            "symmetry_tpu_torch/sched.py": (
                # returned, stored on self, packed into a container
                # slot (the scheduler's hit_units tuple shape), and
                # passed onward to a callee that now owns it
                "def a(idx, t):\n"
                "    hit = idx.lookup(t)\n"
                "    return hit\n"
                "def b(self, idx, t):\n"
                "    self.hit = idx.lookup(t)\n"
                "def c(idx, t, units):\n"
                "    hit = idx.lookup(t)\n"
                "    if hit is None:\n"
                "        return\n"
                "    units[0] = (hit, [t])\n"
                "def d(idx, t, eng):\n"
                "    hit = idx.lookup(t)\n"
                "    if hit is None:\n"
                "        return\n"
                "    eng.start_chunked(t, hit=hit)\n"),
        })
        assert lifecycle_codes(root) == set()

    def test_bare_lock_acquire_flags_and_with_clean(self, tmp_path):
        root = write_tree(tmp_path, {
            "symmetry_tpu_torch/host.py": (
                "def bad(self):\n"
                "    self._lock.acquire()\n"
                "    self.n = work()\n"
                "    return self.n\n"),
            "symmetry_tpu_torch/host2.py": (
                "def good(self):\n"
                "    self._lock.acquire()\n"
                "    try:\n"
                "        self.n = work()\n"
                "    finally:\n"
                "        self._lock.release()\n"
                "    return self.n\n"),
        })
        fs = [f for f in run(root) if f.checker == "lifecycle"]
        assert {f.path for f in fs} == {"symmetry_tpu_torch/host.py"}

    def test_discarded_acquire_flags(self, tmp_path):
        root = write_tree(tmp_path, {
            "symmetry_tpu_torch/sched.py": (
                "def warm(idx, t):\n"
                "    idx.lookup(t)\n"),   # pin dropped on the floor
        })
        assert "L401" in lifecycle_codes(root)

    def test_tests_and_tools_out_of_scope(self, tmp_path):
        root = write_tree(tmp_path, {
            "tests/test_x.py": (
                "def test_pin(idx):\n"
                "    hit = idx.lookup([1])\n"
                "    assert hit.length\n"),
            "tools/probe.py": (
                "def main(idx):\n"
                "    plan = idx.plan_insert([1])\n"),
        })
        assert lifecycle_codes(root) == set()

    def test_tuple_pack_into_local_then_return_transfers(self, tmp_path):
        # `pair = (hit, t); return pair` hands the pin to the caller
        # just as surely as `return hit` — packing through a plain
        # local alias must not read as a leak.
        root = write_tree(tmp_path, {
            "symmetry_tpu_torch/sched.py": (
                "def place(idx, t):\n"
                "    hit = idx.lookup(t)\n"
                "    pair = (hit, t)\n"
                "    return pair\n"),
        })
        assert lifecycle_codes(root) == set()

    def test_attribute_read_through_local_still_leaks(self, tmp_path):
        # The transfer above is maximal-reference only: copying an
        # ATTRIBUTE of the handle into a local reads the pin without
        # moving it — dropping the handle afterwards is still L401.
        root = write_tree(tmp_path, {
            "symmetry_tpu_torch/sched.py": (
                "def peek(idx, t):\n"
                "    hit = idx.lookup(t)\n"
                "    n = hit.length\n"
                "    return n\n"),
        })
        assert "L401" in lifecycle_codes(root)


# ------------------------------------------------------ donation (D5xx)


def donation_codes(root) -> set[str]:
    return {f.code for f in run(root) if f.checker == "donation"}


_DON_PRELUDE = (
    "import jax\n"
    "class E:\n"
    "    def build(self, step):\n"
    "        self._decode = jax.jit(step, donate_argnums=(1,))\n"
)


class TestDonation:
    def test_read_after_donation_flags_D501(self, tmp_path):
        root = write_tree(tmp_path, {
            "symmetry_tpu_torch/engine.py": _DON_PRELUDE + (
                "    def loop(self, tok):\n"
                "        out = self._decode(tok, self.state)\n"
                "        return probe(self.state)\n"),
        })
        assert "D501" in donation_codes(root)

    def test_rebind_idiom_clean(self, tmp_path):
        root = write_tree(tmp_path, {
            "symmetry_tpu_torch/engine.py": _DON_PRELUDE + (
                "    def loop(self, tok):\n"
                "        self.state = self._decode(tok, self.state)\n"
                "        return probe(self.state)\n"),
        })
        assert donation_codes(root) == set()

    def test_partial_path_rebind_still_flags(self, tmp_path):
        # The bug is path-shaped: the happy arm rebinds, the other arm
        # reads the stale name.
        root = write_tree(tmp_path, {
            "symmetry_tpu_torch/engine.py": _DON_PRELUDE + (
                "    def loop(self, tok, ok):\n"
                "        out = self._decode(tok, self.state)\n"
                "        if ok:\n"
                "            self.state = out\n"
                "        return probe(self.state)\n"),
        })
        assert "D501" in donation_codes(root)

    def test_discarded_result_flags_D502(self, tmp_path):
        root = write_tree(tmp_path, {
            "symmetry_tpu_torch/engine.py": _DON_PRELUDE + (
                "    def loop(self, tok):\n"
                "        self._decode(tok, self.state)\n"),
        })
        assert "D502" in donation_codes(root)

    def test_decorator_registration_and_flag(self, tmp_path):
        root = write_tree(tmp_path, {
            "symmetry_tpu_torch/ops.py": (
                "import functools, jax\n"
                "@functools.partial(jax.jit, donate_argnums=(0,))\n"
                "def step(cache, tok):\n"
                "    return cache\n"
                "def drive(cache, tok):\n"
                "    new = step(cache, tok)\n"
                "    return probe(cache)\n"),
        })
        assert "D501" in donation_codes(root)

    def test_augassign_read_of_donated_path_flags_D501(self, tmp_path):
        # `self.state += d` reads the donated buffer to compute the new
        # value — an implicit Load the Store-ctx target hides, and the
        # rebind half must not launder it.
        root = write_tree(tmp_path, {
            "symmetry_tpu_torch/engine.py": _DON_PRELUDE + (
                "    def loop(self, tok, d):\n"
                "        out = self._decode(tok, self.state)\n"
                "        self.state += d\n"
                "        return out\n"),
        })
        assert "D501" in donation_codes(root)

    def test_augassign_after_rebind_clean(self, tmp_path):
        root = write_tree(tmp_path, {
            "symmetry_tpu_torch/engine.py": _DON_PRELUDE + (
                "    def loop(self, tok, d):\n"
                "        self.state = self._decode(tok, self.state)\n"
                "        self.state += d\n"
                "        return self.state\n"),
        })
        assert donation_codes(root) == set()

    def test_deferred_lambda_body_is_not_a_read(self, tmp_path):
        # The lambda runs later — after the very next statement has
        # rebound the name — so its body must not count as a read at
        # the definition site (nested defs likewise).
        root = write_tree(tmp_path, {
            "symmetry_tpu_torch/engine.py": _DON_PRELUDE + (
                "    def loop(self, tok, sched):\n"
                "        out = self._decode(tok, self.state)\n"
                "        sched(lambda: probe(self.state))\n"
                "        self.state = out\n"
                "        return self.state\n"),
        })
        assert donation_codes(root) == set()

    def test_non_donating_jit_clean(self, tmp_path):
        root = write_tree(tmp_path, {
            "symmetry_tpu_torch/ops.py": (
                "import jax\n"
                "class E:\n"
                "    def build(self, fn):\n"
                "        self._f = jax.jit(fn, static_argnums=(2,))\n"
                "    def loop(self, tok):\n"
                "        out = self._f(tok, self.state, 1)\n"
                "        return probe(self.state)\n"),
        })
        assert donation_codes(root) == set()


# --------------------------------------------------------- knobs (K6xx)


_KNOB_CONFIG = (
    "from dataclasses import dataclass\n"
    "@dataclass\n"
    "class TpuConfig:\n"
    "    decode_block: int = 16\n"
    "    max_queue: int = 0\n"
    "    dead_knob: int = 1\n"
)


class TestKnobs:
    def test_all_three_drifts_flag(self, tmp_path):
        root = write_tree(tmp_path, {
            "symmetry_tpu_torch/provider/config.py": _KNOB_CONFIG,
            "symmetry_tpu_torch/engine.py": (
                "def build(tpu_cfg):\n"
                "    q = getattr(tpu_cfg, 'max_queue', 0)\n"
                "    return tpu_cfg.decode_block + q\n"),
            # decode_block documented; a ghost knob documented; a
            # module path that must NOT parse as a knob mention
            "README.md": (
                "Set `tpu.decode_block` to tune dispatch width.\n"
                "Set `tpu.ghost_knob` for good luck.\n"
                "Run `python -m symmetry_tpu_torch.engine.host` by hand.\n"),
        })
        fs = [f for f in run(root) if f.checker == "knobs"]
        by_code = {f.code: f for f in fs}
        assert set(by_code) == {"K601", "K602", "K603"}
        assert by_code["K601"].symbol == "tpu.max_queue"    # read, undoc
        assert by_code["K602"].symbol == "tpu.ghost_knob"   # doc, unknown
        assert by_code["K602"].path == "README.md"
        assert by_code["K603"].symbol == "tpu.dead_knob"    # never read

    def test_aligned_docs_and_reads_clean(self, tmp_path):
        root = write_tree(tmp_path, {
            "symmetry_tpu_torch/provider/config.py": _KNOB_CONFIG,
            "symmetry_tpu_torch/engine.py": (
                "def build(cfg):\n"
                "    tpu_cfg = cfg.tpu\n"
                "    k = tpu_cfg.dead_knob\n"
                "    return tpu_cfg.decode_block + tpu_cfg.max_queue + k\n"),
            "README.md": ("`tpu.decode_block`, `tpu.max_queue` and\n"
                          "`tpu.dead_knob` are documented here.\n"),
        })
        assert [f for f in run(root) if f.checker == "knobs"] == []

    def test_non_tpu_receiver_is_not_a_read(self, tmp_path):
        # `job.decode_block` on some unrelated object must not count as
        # a knob read (the receiver-hint is what scopes the scan).
        root = write_tree(tmp_path, {
            "symmetry_tpu_torch/provider/config.py": _KNOB_CONFIG,
            "symmetry_tpu_torch/other.py": (
                "def f(job):\n"
                "    return job.decode_block\n"),
            "README.md": ("`tpu.decode_block`, `tpu.max_queue`,\n"
                          "`tpu.dead_knob`.\n"),
        })
        fs = [f for f in run(root) if f.checker == "knobs"]
        assert {f.code for f in fs} == {"K603"}
        assert {f.symbol for f in fs} == {
            "tpu.decode_block", "tpu.max_queue", "tpu.dead_knob"}

    def test_no_registry_no_findings(self, tmp_path):
        root = write_tree(tmp_path, {
            "symmetry_tpu_torch/engine.py": "def f(tpu_cfg):\n    return 1\n",
        })
        assert [f for f in run(root) if f.checker == "knobs"] == []


# ------------------------------------------------------- SARIF (--sarif)


class TestRegistriesReadThePort:
    """The lookups that take the first scanned file defining a class
    (knobs' TpuConfig, wire-contract's HostOp) must read the port's when
    the JAX package defines the same class: symmetry_tpu/ sorts first."""

    TREE = {
        # the JAX package's TpuConfig lacks max_queue; the port's has it,
        # and a dead knob of its own
        "symmetry_tpu/provider/config.py": (
            "from dataclasses import dataclass\n"
            "@dataclass\n"
            "class TpuConfig:\n"
            "    decode_block: int = 16\n"),
        "symmetry_tpu_torch/provider/config.py": _KNOB_CONFIG,
        "symmetry_tpu_torch/engine.py": (
            "def build(tpu_cfg):\n"
            "    return tpu_cfg.decode_block + tpu_cfg.max_queue\n"),
        "README.md": ("Set `tpu.decode_block` and `tpu.max_queue`.\n"),
        # the JAX package's HostOp lacks SUBMIT; the port's has it
        "symmetry_tpu/protocol/keys.py": (
            "class HostOp:\n"
            "    EVENT = \"event\"\n"),
        "symmetry_tpu_torch/protocol/keys.py": KEYS_PY,
        "symmetry_tpu_torch/engine/host.py": (
            "from symmetry_tpu_torch.protocol.keys import HostOp\n"
            "def serve(msg):\n"
            "    if msg.get(\"op\") == HostOp.SUBMIT:\n"
            "        return msg\n"),
        "symmetry_tpu_torch/provider/backends/tpu_native.py": (
            "from symmetry_tpu_torch.protocol.keys import HostOp\n"
            "def send(w):\n"
            "    w({\"op\": HostOp.SUBMIT})\n"),
    }

    def test_knobs_read_the_ports_tpu_config(self, tmp_path):
        root = write_tree(tmp_path, self.TREE)
        fs = [f for f in run(root) if f.checker == "knobs"]
        # the port's answer: max_queue is a field (no K602), and only the
        # port's own dead knob is dead, in the port's file
        assert [(f.code, f.symbol, f.path) for f in fs] == [
            ("K603", "tpu.dead_knob",
             "symmetry_tpu_torch/provider/config.py")]

    def test_wire_contract_reads_the_ports_registry(self, tmp_path):
        root = write_tree(tmp_path, self.TREE)
        assert [f for f in run(root) if f.checker == "wire-contract"] == []

    def test_the_jax_suite_would_read_its_own(self, tmp_path):
        """The trap the port's scan avoids: the JAX package's suite, whose
        scan includes symmetry_tpu/, takes that TpuConfig."""
        from symmetry_tpu.analysis import run as jax_run

        root = write_tree(tmp_path, self.TREE)
        fs = [f for f in jax_run(root) if f.checker == "knobs"]
        assert ("K602", "tpu.max_queue") in {(f.code, f.symbol)
                                             for f in fs}


class TestSarif:
    SEEDED = {
        "symmetry_tpu_torch/protocol/keys.py": KEYS_PY,
        "symmetry_tpu_torch/engine/host.py": (
            'from symmetry_tpu_torch.protocol.keys import HostOp\n'
            'def emit(w):\n'
            '    w({"op": HostOp.SUBMIT})\n'
            '    w({"op": HostOp.EVENT})\n'),
    }

    def _run_sarif(self, tmp_path, *extra):
        root = write_tree(tmp_path, self.SEEDED)
        out = os.path.join(str(tmp_path), "out.sarif")
        r = subprocess.run(
            [sys.executable, "-m", "symmetry_tpu_torch.analysis",
             "--root", root, "--checker", "wire-contract",
             "--sarif", out, *extra],
            capture_output=True, text=True, cwd=REPO)
        with open(out, encoding="utf-8") as fh:
            return r, json.load(fh)

    def test_matches_golden(self, tmp_path):
        bl = tmp_path / "bl.json"
        bl.write_text(json.dumps({"version": 1, "suppressions": [
            {"fingerprint":
                 "W102:symmetry_tpu_torch/engine/host.py:submit",
             "reason": "seeded suppression for the golden file"}]}))
        r, doc = self._run_sarif(tmp_path, "--baseline", str(bl))
        assert r.returncode == 1   # the EVENT finding is new
        # The JAX suite's golden file, its paths moved to the port: the
        # port's runner writes the same document for the same tree.
        with open(os.path.join(REPO, "tests", "data",
                               "sarif_golden.json"),
                  encoding="utf-8") as fh:
            golden = json.loads(fh.read().replace(
                "symmetry_tpu/", "symmetry_tpu_torch/"))
        assert doc == golden

    def test_schema_shape(self, tmp_path):
        r, doc = self._run_sarif(tmp_path)
        assert doc["version"] == "2.1.0"
        assert doc["$schema"].endswith("sarif-2.1.0.json")
        run_ = doc["runs"][0]
        driver = run_["tool"]["driver"]
        assert driver["name"] == "symlint"
        rule_ids = {rule["id"] for rule in driver["rules"]}
        assert {"W101", "W102", "W107"} <= rule_ids
        for res in run_["results"]:
            assert res["ruleId"] in rule_ids
            assert res["level"] in ("error", "note")
            loc = res["locations"][0]["physicalLocation"]
            assert loc["artifactLocation"]["uri"].endswith(".py")
            assert loc["region"]["startLine"] >= 1
            assert res["partialFingerprints"]["symlintFingerprint/v1"]
        # no baseline → nothing suppressed, everything an error
        assert all(res["level"] == "error" and "suppressions" not in res
                   for res in run_["results"])


# --------------------------------------- randomized CFG ground-truth test


class _Gen:
    """Random function generator with an independent reference model.

    Emits nested if/try-finally/try-except/early-return bodies over one
    `idx.lookup` handle, built from a grammar small enough to simulate
    EXACTLY: `outcomes(body)` enumerates every (exit-kind, still-held)
    pair the dataflow engine should discover — including the engine's
    own conventions (any call can raise; a release that raises still
    released; catch-all handlers stop the unwind). The lifecycle
    checker's leak verdict must equal the reference's on every seed; a
    divergence is a CFG or transfer bug, pinpointed by the seed.
    """

    def __init__(self, rng):
        self.rng = rng

    def body(self, depth):
        n = self.rng.randint(1, 3)
        return [self.item(depth) for _ in range(n)]

    def item(self, depth):
        atoms = ["noop", "boom", "release", "relif", "ret"]
        if depth <= 0:
            return self.rng.choice(atoms)
        kind = self.rng.choice(atoms + ["if", "tryfin", "tryexc"])
        if kind == "if":
            return ("if", self.body(depth - 1), self.body(depth - 1))
        if kind == "tryfin":
            fin = [self.rng.choice(["noop", "release", "relif"])]
            return ("tryfin", self.body(depth - 1), fin)
        if kind == "tryexc":
            return ("tryexc", self.body(depth - 1), self.body(depth - 1))
        return kind

    # ------------------------------------------------------------ render

    def render(self, items, ind):
        pad = "    " * ind
        out = []
        for it in items:
            if it == "noop":
                out.append(f"{pad}x = 1")
            elif it == "boom":
                out.append(f"{pad}boom()")
            elif it == "release":
                out.append(f"{pad}h.release()")
            elif it == "relif":
                # the guarded-cleanup idiom: past the prelude h is
                # never None, so this is exactly a release — but the
                # CHECKER must prove that via branch narrowing (held
                # handles are not None), incl. inside finally clones
                out.append(f"{pad}if h is not None:")
                out.append(f"{pad}    h.release()")
            elif it == "ret":
                out.append(f"{pad}return 1")
            elif it[0] == "if":
                out.append(f"{pad}if flag:")
                out += self.render(it[1], ind + 1)
                out.append(f"{pad}else:")
                out += self.render(it[2], ind + 1)
            elif it[0] == "tryfin":
                out.append(f"{pad}try:")
                out += self.render(it[1], ind + 1)
                out.append(f"{pad}finally:")
                out += self.render(it[2], ind + 1)
            elif it[0] == "tryexc":
                out.append(f"{pad}try:")
                out += self.render(it[1], ind + 1)
                out.append(f"{pad}except Exception:")
                out += self.render(it[2], ind + 1)
        return out

    # --------------------------------------------------------- reference

    def outcomes(self, items, held):
        """Exact exit set of `items` entered holding `held`:
        {(kind, held')} with kind in fall/ret/exc."""
        outs = set()
        cur = {held}
        for it in items:
            nxt = set()
            for h in cur:
                for kind, h2 in self._one(it, h):
                    if kind == "fall":
                        nxt.add(h2)
                    else:
                        outs.add((kind, h2))
            cur = nxt
        return outs | {("fall", h) for h in cur}

    def _one(self, it, held):
        if it == "noop":
            return {("fall", held)}
        if it == "boom":
            return {("fall", held), ("exc", held)}
        if it in ("release", "relif"):
            # the engine's convention: a release that raises released;
            # relif's guard is always true past the prelude (and on an
            # already-released path the skip changes nothing)
            return {("fall", False), ("exc", False)}
        if it == "ret":
            return {("ret", held)}
        if it[0] == "if":
            return self.outcomes(it[1], held) | self.outcomes(it[2], held)
        if it[0] == "tryfin":
            outs = set()
            for kind, h in self.outcomes(it[1], held):
                for fk, fh in self.outcomes(it[2], h):
                    outs.add((kind if fk == "fall" else fk, fh))
            return outs
        if it[0] == "tryexc":
            outs = set()
            for kind, h in self.outcomes(it[1], held):
                if kind == "exc":
                    outs |= self.outcomes(it[2], h)
                else:
                    outs.add((kind, h))
            return outs
        raise AssertionError(it)


class TestRandomizedLifecycleGroundTruth:
    def test_checker_matches_reference_on_random_cfgs(self):
        import random

        from symmetry_tpu_torch.analysis import lifecycle
        from symmetry_tpu_torch.analysis.core import Project, parse_source

        verdicts = set()
        for seed in range(120):
            g = _Gen(random.Random(seed))
            items = g.body(depth=3)
            src = "\n".join(
                ["def f(idx, flag):",
                 "    h = idx.lookup([1])",
                 "    if h is None:",
                 "        return 0"]
                + g.render(items, 1)) + "\n"
            expect_leak = any(
                h for _, h in g.outcomes(items, held=True))
            sf = parse_source("symmetry_tpu_torch/gen.py",
                              "symmetry_tpu_torch/gen.py", src)
            assert sf.tree is not None, src
            fs = lifecycle.check(Project("", [sf]))
            got = {f.code for f in fs}
            assert got <= {"L401", "L402"}, (src, got)
            got_leak = bool(got)
            assert got_leak == expect_leak, (
                f"seed {seed}: checker={'leak' if got_leak else 'clean'} "
                f"reference={'leak' if expect_leak else 'clean'}\n{src}")
            verdicts.add(expect_leak)
        # the generator must exercise BOTH verdicts or this test is
        # vacuous
        assert verdicts == {True, False}
