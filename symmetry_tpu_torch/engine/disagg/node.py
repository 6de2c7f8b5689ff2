"""Prefill-tier node: the standalone half of a cross-machine disagg pair.

Runs on the PREFILL machine. Owns (a) a prefill engine host subprocess
(the same `engine/host.py` the local pair uses, `tpu.role: prefill`
derived from this node's config) and (b) the listening end of the
handoff link (`engine/disagg/net.py`): the decode-tier provider dials
`tpu.disagg.peer`, which is this node's `tpu.disagg.listen` address.

Data path (serial on purpose — the serial pump is the backpressure
chain the credit window feeds, see net.py):

    link submit/cancel ──▶ host stdin
    host stdout handoff lines ──▶ base64-decode ──▶ chunked, credit-
        gated, acked link transfer (HandoffSender)
    host stdout event lines ──▶ link `event` (prefill-tier terminal
        errors: tokenization failures, deadline sheds)
    link stats/trace probes ──▶ host stdin probe ──▶ reply + node-side
        link counters ride back over the link

Supervision is INDEPENDENT of the decode machine's: a dead or wedged
prefill host is respawned here with exponential backoff (warm compile
cache makes it cheap). While the host is down the node DROPS the link —
on the decode side that sheds every in-flight migration structured-
retryable (client failover) and triggers its reconnect-with-backoff
loop, which lands on the respawned host. Crossing machine boundaries,
"the pair restarts as one unit" (the local-pair model) is replaced by
"each tier restarts alone and the LINK is the failure domain between
them".

Run: python -m symmetry_tpu.engine.disagg.node <provider-config.yaml>
(the config needs `tpu.role: disagg` semantics only for deriving the
prefill tier; `tpu.disagg.listen` names the bind address).
"""

from __future__ import annotations

import asyncio
import base64
import contextlib
import json
import sys
import time
from typing import Any

from symmetry_tpu_torch.engine.disagg.broker import derive_role_config
from symmetry_tpu_torch.engine.disagg.net import (
    LinkConfig,
    LinkError,
    PrefillLink,
    link_transport,
    secure_link,
)
from symmetry_tpu_torch.protocol.keys import HostOp, LinkOp
from symmetry_tpu_torch.utils.faults import FAULTS
from symmetry_tpu_torch.utils.logging import logger as log

# Handoff frames ride the host pipe as single base64 lines (~4/3 × raw
# KV bytes); same bound as the backend's disagg reader.
_HOST_PIPE_LIMIT = 1 << 30


class PrefillNode:
    """One prefill-tier node: prefill engine host + link listener."""

    def __init__(self, config: Any, *, listen: str | None = None,
                 device: str = "cuda") -> None:
        self._config = config
        self._device = device  # the prefill engine host's torch device
        self._link_cfg = LinkConfig(getattr(config.tpu, "disagg", None))
        self._listen = listen or self._link_cfg.listen
        if not self._listen:
            raise ValueError(
                "prefill node needs tpu.disagg.listen (or an explicit "
                "listen address)")
        # Pool identity: announced in the link hello so the decode
        # side's router names this member stably across reconnects.
        # Defaults to the (resolved) listen address.
        self._node_id: str | None = self._link_cfg.node_id
        self._draining = False
        sup = config.tpu.supervisor or {}
        self._backoff_base_s = float(sup.get("backoff_base_s", 0.5))
        self._backoff_max_s = float(sup.get("backoff_max_s", 15.0))
        self._max_respawns = int(sup.get("max_respawns", 3))
        self._min_stable_s = float(sup.get("min_stable_s", 5.0))
        self._stop_grace_s = float(sup.get("stop_grace_s", 30.0))
        self._proc: asyncio.subprocess.Process | None = None
        self._cfg_path: str | None = None
        self._listener = None
        self._plink: PrefillLink | None = None
        # (the link serve pump runs on the transport's accept-handler
        # task — see _on_connection; the node never owns it)
        self._pump_task: asyncio.Task | None = None
        self._supervisor_task: asyncio.Task | None = None
        self._host_down: asyncio.Event | None = None
        # Set when supervision gives up (max_respawns consecutive
        # short-lived host lives): the standalone entrypoint exits on
        # it; an INLINE node must never kill its embedding provider —
        # it just stops serving (listener closed, link dropped), and
        # the decode side sheds retryable on every dial.
        self.failed: asyncio.Event = asyncio.Event()
        self._spawned_at: float | None = None
        self._respawn_failures = 0
        self._stopped = False
        self._stats_waiters: list[asyncio.Future] = []
        self._trace_waiters: list[asyncio.Future] = []
        self.stats = {"links_accepted": 0, "host_restarts": 0,
                      "handoffs_pumped": 0}

    # ------------------------------------------------------------ address

    @property
    def address(self) -> str:
        """The dialable bound address (resolves tcp://host:0 → the real
        port) — the value the decode side's `tpu.disagg.peer` wants."""
        if self._listener is None:
            return self._listen
        return self._listener.address

    @property
    def node_id(self) -> str:
        return self._node_id or self.address

    @property
    def draining(self) -> bool:
        return self._draining

    # ---------------------------------------------------------- lifecycle

    def _host_argv(self, cfg_path: str) -> list[str]:
        """Command line for the prefill engine host. A seam on purpose
        (mirrors the backend's): tests substitute a protocol-faithful
        fake host to drive the link without a JAX build."""
        argv = [sys.executable, "-m", "symmetry_tpu_torch.engine.host",
                cfg_path]
        return (argv if self._device == "cuda"
                else argv + ["--device", self._device])

    async def start(self) -> None:
        import tempfile

        import yaml

        FAULTS.load(self._config.get("faults"))
        cfg = {k: v for k, v in self._config.get_all().items()
               if k != "apiKey"}
        with tempfile.NamedTemporaryFile("w", suffix=".yaml",
                                         delete=False) as fh:
            yaml.safe_dump(derive_role_config(cfg, "prefill"), fh)
            self._cfg_path = fh.name
        self._host_down = asyncio.Event()
        await self._spawn_host()
        transport = link_transport(self._listen)
        self._listener = await transport.listen(self._listen,
                                                self._on_connection)
        self._supervisor_task = asyncio.get_running_loop().create_task(
            self._supervise())
        log.info(f"prefill node up: host pid {self._proc.pid}, "
                 f"listening {self.address}")

    async def drain(self) -> None:
        """Deliberate drain: announce over the live link (the decode
        side's pool router excludes this member from NEW placements;
        in-flight work finishes here). Sticky across reconnects — a
        link that re-establishes mid-drain gets the announce again."""
        self._draining = True
        plink = self._plink
        if plink is not None and not plink.closed:
            with contextlib.suppress(LinkError):
                await plink.send_drain()
        log.info(f"prefill node {self.node_id}: draining")

    async def kill(self) -> None:
        """Chaos drill: die like a CRASHED node — no drain, no leave.
        The listener closes, the link cuts mid-whatever, the host is
        SIGKILLed. The decode side must account it as membership churn
        (member lost, in-flight re-placed), never as a clean leave."""
        self._stopped = True
        for task in (self._supervisor_task, self._pump_task):
            if task is not None:
                task.cancel()
        self._supervisor_task = self._pump_task = None
        if self._listener is not None:
            await self._listener.close()
            self._listener = None
        if self._plink is not None:
            await self._plink.close()
            self._plink = None
        if self._proc is not None:
            with contextlib.suppress(ProcessLookupError):
                self._proc.kill()
            with contextlib.suppress(Exception):
                await self._proc.wait()
            self._proc = None
        if self._cfg_path:
            import os

            with contextlib.suppress(OSError):
                os.unlink(self._cfg_path)
            self._cfg_path = None

    async def stop(self) -> None:
        self._stopped = True
        plink = self._plink
        if plink is not None and not plink.closed:
            # Departure is membership churn, not a fault: the leave
            # announce lets the router account it as such (best-effort —
            # a dead link already told the peer the louder way).
            with contextlib.suppress(LinkError):
                await plink.send_leave()
        for task in (self._supervisor_task, self._pump_task):
            if task is not None:
                task.cancel()
                with contextlib.suppress(asyncio.CancelledError):
                    await task
        self._supervisor_task = self._pump_task = None
        if self._plink is not None:
            await self._plink.close()
            self._plink = None
        if self._listener is not None:
            await self._listener.close()
            self._listener = None
        if self._proc is not None:
            with contextlib.suppress(ConnectionError, OSError):
                await self._host_send_line(json.dumps(
                    {"op": HostOp.SHUTDOWN}).encode())
            try:
                await asyncio.wait_for(self._proc.wait(),
                                       self._stop_grace_s)
            except asyncio.TimeoutError:
                self._proc.kill()
                await self._proc.wait()
            self._proc = None
        if self._cfg_path:
            import os

            with contextlib.suppress(OSError):
                os.unlink(self._cfg_path)
            self._cfg_path = None

    # --------------------------------------------------------------- host

    async def _spawn_host(self) -> None:
        self._proc = await asyncio.create_subprocess_exec(
            *self._host_argv(self._cfg_path),
            stdin=asyncio.subprocess.PIPE,
            stdout=asyncio.subprocess.PIPE,
            limit=_HOST_PIPE_LIMIT)
        # Read frames until ready (weight load + warmup happen first).
        while True:
            line = await self._proc.stdout.readline()
            if not line:
                rc = await self._proc.wait()
                raise RuntimeError(
                    f"prefill host died during startup (rc={rc})")
            try:
                msg = json.loads(line)
            except ValueError:
                continue
            if isinstance(msg, dict) and msg.get("op") == HostOp.READY:
                break
        self._spawned_at = time.monotonic()
        self._pump_task = asyncio.get_running_loop().create_task(
            self._pump_host())

    async def _host_send_line(self, line: bytes) -> None:
        proc = self._proc
        if (proc is None or proc.stdin is None
                or proc.stdin.is_closing()):
            raise ConnectionError("prefill host pipe unavailable")
        proc.stdin.write(line.rstrip(b"\n") + b"\n")
        await proc.stdin.drain()

    async def _pump_host(self) -> None:
        """Host stdout → link. Serial: a handoff transfer completes (or
        fails) before the next stdout line is read — that is how link
        backpressure reaches the host pipe and, through the handoff
        sink, the prefill scheduler's admissions."""
        proc = self._proc
        try:
            while True:
                line = await proc.stdout.readline()
                if not line:
                    break  # host exited
                try:
                    msg = json.loads(line)
                except ValueError:
                    continue
                if not isinstance(msg, dict):
                    continue
                op = msg.get("op")
                if op == HostOp.HANDOFF:
                    await self._pump_handoff(msg)
                elif op in (HostOp.EVENT, HostOp.EVENTS):
                    plink = self._plink
                    if plink is not None and not plink.closed:
                        with contextlib.suppress(LinkError):
                            await plink.send_event(msg)
                elif op == HostOp.STATS:
                    waiters, self._stats_waiters = self._stats_waiters, []
                    for w in waiters:
                        if not w.done():
                            w.set_result(msg)
                elif op == HostOp.TRACE:
                    waiters, self._trace_waiters = self._trace_waiters, []
                    for w in waiters:
                        if not w.done():
                            w.set_result(msg)
                # ready/clock replies outside a respawn window: ignore.
        except asyncio.CancelledError:
            raise  # respawn/stop cancelling us is not a host death
        except Exception as exc:  # noqa: BLE001 — pump must never die
            # silently: nobody would read host stdout again and every
            # request would hang while the node looks healthy. Treat it
            # as a host-life failure — supervision replaces the life.
            log.error(f"prefill node: host pump failed: {exc!r}")
        finally:
            if not self._stopped:
                self._host_down.set()

    async def _pump_handoff(self, msg: dict[str, Any]) -> None:
        plink = self._plink
        frame_b64 = msg.get("frame")
        if plink is None or plink.closed or not isinstance(frame_b64, str):
            return  # no link: the decode side owns request recovery
        try:
            frame = base64.b64decode(frame_b64, validate=True)
        except ValueError:
            log.error("prefill host emitted an undecodable handoff "
                      "frame; dropping it")
            return
        meta = {"id": str(msg.get("id", "")), "p": int(msg.get("p", 0)),
                "prompt_len": int(msg.get("prompt_len", 0)),
                "nbytes": len(frame),
                # Ledger accounting rides to the receiving broker: the
                # manifest's block count vs the blocks whose payload is
                # actually in this frame (the warm-handoff savings).
                "blocks": int(msg.get("blocks", 0)),
                "shipped": int(msg.get("shipped", 0))}
        self.stats["handoffs_pumped"] += 1
        ok = await plink.send_handoff(meta, frame)
        if not ok:
            log.warning(f"handoff {meta['id']} not delivered "
                        f"(link down or retries exhausted)")

    async def _forward_command(self, line: bytes) -> None:
        """Link submit/cancel → host stdin. A host that is mid-respawn
        (or not yet ready) cannot take the command — fail THAT request
        fast over the link with a retryable shed instead of letting the
        decode side's stream hang on a submit nobody holds."""
        try:
            await self._host_send_line(line)
            return
        except (ConnectionError, OSError):
            pass
        try:
            msg = json.loads(line)
        except ValueError:
            return
        if not isinstance(msg, dict) or msg.get("op") != HostOp.SUBMIT:
            return  # lost cancels are harmless (nobody is waiting)
        req_id = str(msg.get("id", ""))
        plink = self._plink
        if req_id and plink is not None and not plink.closed:
            with contextlib.suppress(LinkError):
                await plink.send_event(
                    {"op": HostOp.EVENT, "id": req_id, "text": "",
                     "done": True, "finish_reason": "error",
                     "restarting": True,
                     "error": "prefill host restarting"})

    async def _probe_host(self, op: str,
                          timeout: float = 10.0) -> dict | None:
        waiters = (self._stats_waiters if op == HostOp.STATS
                   else self._trace_waiters)
        fut: asyncio.Future = asyncio.get_running_loop().create_future()
        waiters.append(fut)
        try:
            try:
                await self._host_send_line(
                    json.dumps({"op": op}).encode())
            except (ConnectionError, OSError):
                # Host down/mid-respawn: no reply is ever coming —
                # answer None NOW instead of holding the decode side's
                # equal-timeout link probe hostage for the full window.
                return None
            return await asyncio.wait_for(fut, timeout)
        except asyncio.TimeoutError:
            return None
        finally:
            if fut in waiters:
                waiters.remove(fut)

    # --------------------------------------------------------------- link

    async def _on_connection(self, conn) -> None:
        """Transport accept handler. One live link at a time: a
        reconnect (the decode side's backoff loop redialing after a
        drop) replaces the previous connection."""
        try:
            link = await secure_link(conn, self._link_cfg,
                                     initiator=False)
            plink = PrefillLink(link, self._link_cfg,
                                on_command=self._forward_command,
                                on_probe=self._link_probe,
                                node_id=self.node_id)
            await plink.handshake()
        except Exception as exc:  # noqa: BLE001 — reject bad dialers
            log.warning(f"handoff link handshake rejected: {exc}")
            await conn.close()
            return
        old, self._plink = self._plink, plink
        if old is not None:
            old.fail_inflight()
            await old.close()
        self.stats["links_accepted"] += 1
        log.info(f"handoff link accepted from {link.remote_address}")
        if self._draining:
            # Drain is sticky: a link re-established mid-drain must not
            # silently rejoin the placement set.
            with contextlib.suppress(LinkError):
                await plink.send_drain()
        # Serve inline on the handler task: the transport layer keeps it
        # alive until serve() returns (EOF / link error). The finally
        # guarantees a pump killed by ANY exception (malformed header
        # field, not just LinkError) still fails in-flight transfers
        # and clears the slot — otherwise the decode side keeps
        # forwarding submits into a connection nobody reads.
        try:
            reason = await plink.serve()
        except Exception as exc:  # noqa: BLE001 — see above
            reason = f"link pump error: {exc!r}"
        finally:
            plink.fail_inflight()
            if self._plink is plink:
                self._plink = None
            await plink.close()
        log.warning(f"handoff link closed ({reason})")

    async def _link_probe(self, op: str) -> dict | None:
        """stats/trace probe arriving over the link: host reply plus
        this node's own link-side counters."""
        host_op = (HostOp.STATS if op == LinkOp.STATS else HostOp.TRACE)
        reply = await self._probe_host(host_op)
        if op == LinkOp.TRACE:
            return reply
        plink = self._plink
        node = dict(self.stats)
        node["respawn_failures"] = self._respawn_failures
        if plink is not None:
            node.update(plink.stats())
        if FAULTS.enabled:
            node["faults"] = FAULTS.counters()
        return {"host": reply, "node": node}

    # --------------------------------------------------------- supervision

    async def _supervise(self) -> None:
        """Host death → drop the link (decode side sheds in-flight and
        reconnects), respawn with backoff; too many consecutive
        short-lived lives → give up and exit the node (the deployment
        layer restarts it; crash-looping forever helps nobody)."""
        while not self._stopped:
            await self._host_down.wait()
            self._host_down.clear()
            if self._stopped:
                return
            if (self._spawned_at is not None
                    and time.monotonic() - self._spawned_at
                    >= self._min_stable_s):
                self._respawn_failures = 0
            else:
                self._respawn_failures += 1
            plink, self._plink = self._plink, None
            if plink is not None:
                plink.fail_inflight()
                await plink.close()
            if self._pump_task is not None:
                self._pump_task.cancel()
                with contextlib.suppress(asyncio.CancelledError):
                    await self._pump_task
                self._pump_task = None
            if self._proc is not None:
                with contextlib.suppress(ProcessLookupError):
                    self._proc.kill()
                with contextlib.suppress(Exception):
                    await self._proc.wait()
                self._proc = None
            while not self._stopped:
                if self._respawn_failures >= self._max_respawns:
                    log.error(
                        f"prefill node: {self._respawn_failures} "
                        f"consecutive failed host lives; giving up "
                        f"(listener closed; deployment layer restarts "
                        f"the node)")
                    if self._listener is not None:
                        await self._listener.close()
                        self._listener = None
                    self.failed.set()
                    return
                backoff = min(
                    self._backoff_max_s,
                    self._backoff_base_s
                    * (2 ** min(self._respawn_failures, 8)))
                log.warning(f"prefill node: respawning host in "
                            f"{backoff:.2f}s")
                await asyncio.sleep(backoff)
                try:
                    await self._spawn_host()
                except Exception as exc:  # noqa: BLE001 — spawn failed
                    self._respawn_failures += 1
                    log.error(f"prefill node: host respawn failed: {exc}")
                    continue
                self.stats["host_restarts"] += 1
                log.warning(f"prefill node: host respawned "
                            f"(pid {self._proc.pid})")
                break


async def _serve(config_path: str, device: str = "cuda") -> int:
    from symmetry_tpu_torch.provider.config import ConfigManager

    config = ConfigManager(config_path=config_path)
    node = PrefillNode(config, device=device)
    await node.start()
    stop = asyncio.Event()
    import signal

    loop = asyncio.get_running_loop()
    # SIGTERM = deliberate drain: announce (router stops placing here),
    # let in-flight work finish for drain_grace_s, then leave + exit.
    # A second SIGTERM — or SIGINT — stops immediately.
    grace_s = float((getattr(config.tpu, "disagg", None) or {})
                    .get("drain_grace_s", 30.0))

    drain_started = False

    def _on_term() -> None:
        # Flag locally, not via node.draining: the drain() task may not
        # have RUN yet when a rapid second SIGTERM arrives — that second
        # signal must stop now, not arm another grace timer.
        nonlocal drain_started
        if drain_started:
            stop.set()
        else:
            drain_started = True
            asyncio.ensure_future(node.drain())
            loop.call_later(grace_s, stop.set)

    with contextlib.suppress(NotImplementedError):
        loop.add_signal_handler(signal.SIGTERM, _on_term)
    with contextlib.suppress(NotImplementedError):
        loop.add_signal_handler(signal.SIGINT, stop.set)
    try:
        _, pending = await asyncio.wait(
            [asyncio.ensure_future(stop.wait()),
             asyncio.ensure_future(node.failed.wait())],
            return_when=asyncio.FIRST_COMPLETED)
        for fut in pending:
            fut.cancel()  # a pending waiter at loop teardown is stderr
            # noise ("Task was destroyed…") in the logs verify greps
    finally:
        failed = node.failed.is_set()
        await node.stop()
    return 86 if failed else 0


def main() -> int:
    args = sys.argv[1:]
    device = "cuda"
    if len(args) == 3 and args[1] == "--device":
        args, device = args[:1], args[2]
    if len(args) != 1:
        print("usage: python -m symmetry_tpu_torch.engine.disagg.node "
              "<config.yaml> [--device cpu]", file=sys.stderr)
        return 2
    return asyncio.new_event_loop().run_until_complete(
        _serve(args[0], device))


if __name__ == "__main__":
    sys.exit(main())
