"""Cross-machine KV-handoff link: the disagg pair over a real network.

The local disaggregated prefill/decode pair only moves handoff frames
across local subprocess pipes on one machine. This module is the
transport that puts the two tiers on separate machines — the link
DistServe and Splitwise treat as the central engineering problem of
disaggregated serving (PAPERS.md): its bandwidth, its flow control, and
its failure behavior all shape the prefill tier's admission rate and the
decode tier's TTFT. It rides the project's injectable transport seam
(transport/base.py): MemoryTransport in tests, TCP in production, and
optionally the same Noise handshake the peer stack uses
(symmetry_tpu.identity) when `tpu.disagg.encrypt` is on.

Topology (static pairing, `tpu.disagg.peer`):

    prefill machine                         decode machine
    ───────────────                         ──────────────
    engine/disagg/node.py                   tpu_native provider
      prefill engine host  ◀── pipe ──┐       decode engine host
      (admissions, chunked prefill)   │       (adoption, generation)
              │ {"op":"handoff"}      │              ▲ {"op":"adopt"}
              ▼                       │              │
      PrefillLink ═══ begin/chunk/end/ack over tcp ══ DecodeLink
                      (this module)

Protocol (LinkOp registry in protocol/keys.py; symlint wire-contract
enforced): each message is a self-delimiting envelope —

    magic b"SYLK" | u32 header-JSON length | u32 payload length |
    header JSON ({"op": ...} + fields) | raw payload bytes

parsed by a STREAMING decoder, so reassembly survives a transport that
fragments or coalesces arbitrarily (the envelope carries its own
boundaries; transport frame boundaries are never load-bearing).

Flow control is credit-based: the decode side advertises a byte window
at hello; every chunk the sender ships consumes credit, every chunk the
decode pump consumes grants it back. Transfers are SERIAL per link and
acked only after the reassembled frame has been written (and drained)
onto the decode host's stdin — so a slow decode tier stops granting
credit/acks, the sender blocks, the prefill node stops reading its
host's stdout, the host's pipe write blocks the engine thread inside the
scheduler's handoff sink, and prefill ADMISSIONS throttle. Bounded
in-flight bytes end to end, no ballooning queue of orphaned KV.

Failure model: a transfer that fails integrity (length/CRC) is nak'd and
retransmitted under a fresh transfer id, up to `max_retries`; an unacked
transfer times out and retransmits the same way; retries exhausted →
`fail`, and the decode node sheds that one request through the existing
structured-retryable path (client failover). A dropped LINK discards
every partial reassembly buffer (the decode tier never adopts a partial
frame — adoption only ever sees length- and CRC-verified complete
frames), sheds every in-flight migration the same retryable way, and
reconnects with exponential backoff. Fault seams: `disagg.net.send`
(per message), `disagg.net.recv` (per message), `disagg.net.drop_link`
(per transfer attempt, after the first chunk — a deterministic
mid-handoff cable pull).

Clock: each connect runs the same NTP-style min-RTT handshake as the
host pipe (utils/trace.clock_handshake_offset), so handoff stamps from
the prefill machine land on the decode machine's clock — the broker's
deadline rebasing and the wire-latency split survive skewed clocks.
"""

from __future__ import annotations

import asyncio
import json
import struct
import time
import uuid
import zlib
from typing import Any, Awaitable, Callable

from symmetry_tpu_torch.protocol.keys import LinkOp
from symmetry_tpu_torch.transport.base import Connection, Transport
from symmetry_tpu_torch.utils.faults import FAULTS
from symmetry_tpu_torch.utils.logging import logger as log
from symmetry_tpu_torch.utils.metrics import METRICS, MetricName

LINK_VERSION = 1
MAGIC = b"SYLK"
_FIXED = struct.Struct("<4sII")

# Envelope bounds: a poisoned length prefix must fail parsing, not drive
# a multi-GB allocation. Chunks are capped well under the TCP framing
# layer's 32 MiB frame bound (protocol/framing.MAX_FRAME_SIZE) — the
# envelope plus Noise overhead must still fit one transport frame.
MAX_HEADER_BYTES = 1 << 20
MAX_PAYLOAD_BYTES = 16 << 20
MAX_CHUNK_BYTES = 8 << 20

DEFAULT_CHUNK_BYTES = 1 << 20
DEFAULT_CREDIT_BYTES = 64 << 20
# Reassembly bounds (decode side): one transfer may not claim more than
# the host pipe's own handoff line limit, and a sender is SERIAL by
# protocol, so more than a couple of live transfers is a protocol
# violation — both caps keep a rogue or corrupted peer from growing
# decode-side buffers without limit on an unencrypted listener.
MAX_TRANSFER_BYTES = 1 << 30
MAX_ACTIVE_TRANSFERS = 2
DEFAULT_ACK_TIMEOUT_S = 30.0
DEFAULT_MAX_RETRIES = 2
DEFAULT_RECONNECT_BASE_S = 0.5
DEFAULT_RECONNECT_MAX_S = 15.0
CLOCK_ROUNDS = 5


class LinkError(ConnectionError):
    """The handoff link failed (protocol violation, drop, or teardown)."""


# ------------------------------------------------------------- envelope


def encode_link_msg(header: dict[str, Any], payload: bytes = b"") -> bytes:
    """One link message → self-delimiting bytes (see module docstring)."""
    hdr = json.dumps(header, separators=(",", ":")).encode()
    if len(hdr) > MAX_HEADER_BYTES:
        raise LinkError(f"link header too large: {len(hdr)} bytes")
    if len(payload) > MAX_PAYLOAD_BYTES:
        raise LinkError(f"link payload too large: {len(payload)} bytes")
    return b"".join([_FIXED.pack(MAGIC, len(hdr), len(payload)), hdr,
                     payload])


class LinkDecoder:
    """Streaming envelope parser: feed arbitrary byte blobs, iterate
    complete (header, payload) messages. Boundary-agnostic on purpose —
    the reassembly contract must hold over a transport that fragments
    and coalesces however it likes."""

    def __init__(self) -> None:
        self._buf = bytearray()

    def feed(self, data: bytes):
        self._buf.extend(data)
        while True:
            if len(self._buf) < _FIXED.size:
                return
            magic, hlen, plen = _FIXED.unpack_from(self._buf)
            if magic != MAGIC:
                raise LinkError(f"bad link magic {bytes(magic)!r}")
            if hlen > MAX_HEADER_BYTES or plen > MAX_PAYLOAD_BYTES:
                raise LinkError(
                    f"link message too large (header {hlen}, "
                    f"payload {plen})")
            total = _FIXED.size + hlen + plen
            if len(self._buf) < total:
                return
            try:
                header = json.loads(
                    bytes(self._buf[_FIXED.size:_FIXED.size + hlen]))
            except ValueError as exc:
                raise LinkError(f"link header is not JSON: {exc}") from exc
            if not isinstance(header, dict):
                raise LinkError("link header must be a JSON object")
            payload = bytes(self._buf[_FIXED.size + hlen:total])
            del self._buf[:total]
            yield header, payload


# ------------------------------------------------------------ link layer


class HandoffLink:
    """One live link: envelope codec + optional Noise encryption + the
    send/recv fault seams, over a frame Connection."""

    def __init__(self, conn: Connection, session: Any = None) -> None:
        self._conn = conn
        self._session = session  # identity.SecureSession or None
        self._decoder = LinkDecoder()
        self._pending: list[tuple[dict, bytes]] = []
        self.stats = {"msgs_sent": 0, "msgs_recvd": 0,
                      "bytes_sent": 0, "bytes_recvd": 0}

    @property
    def closed(self) -> bool:
        return self._conn.closed

    @property
    def remote_address(self) -> str:
        return self._conn.remote_address

    async def send(self, header: dict[str, Any],
                   payload: bytes = b"") -> None:
        if FAULTS.enabled and await FAULTS.apoint("disagg.net.send"):
            return  # injected drop: the message is lost on the wire
        data = encode_link_msg(header, payload)
        if self._session is not None:
            data = self._session.encrypt(data)
        self.stats["msgs_sent"] += 1
        self.stats["bytes_sent"] += len(data)
        try:
            await self._conn.send(data)
        except (ConnectionError, OSError) as exc:
            raise LinkError(f"link send failed: {exc}") from exc

    async def recv(self) -> tuple[dict[str, Any], bytes] | None:
        """Next decoded message, or None on EOF/teardown. Protocol
        violations raise LinkError — the caller drops the link (a
        corrupted stream cannot be resynchronized; reconnect instead)."""
        while True:
            if self._pending:
                header, payload = self._pending.pop(0)
                if (FAULTS.enabled
                        and await FAULTS.apoint("disagg.net.recv")):
                    continue  # injected drop: message vanishes on ingress
                return header, payload
            try:
                frame = await self._conn.recv()
            except (ConnectionError, OSError):
                return None
            if frame is None:
                return None
            if self._session is not None:
                try:
                    frame = self._session.decrypt(frame)
                except Exception as exc:
                    raise LinkError(f"link decrypt failed: {exc}") from exc
            self.stats["msgs_recvd"] += 1
            self.stats["bytes_recvd"] += len(frame)
            self._pending.extend(self._decoder.feed(frame))

    def requeue(self, msgs: list[tuple[dict[str, Any], bytes]]) -> None:
        """Put already-received messages back at the FRONT of the inbox
        (arrival order preserved) — used by the clock handshake, which
        reads inline before the pump exists and must not discard
        unrelated traffic the peer sent concurrently."""
        self._pending[:0] = msgs

    async def drop(self, reason: str = "") -> None:
        """Hard-cut the link (fault injection / protocol violation)."""
        if reason:
            log.warning(f"handoff link dropped: {reason}")
        await self._conn.close()

    async def close(self) -> None:
        await self._conn.close()


async def secure_link(conn: Connection, cfg: "LinkConfig",
                      *, initiator: bool) -> HandoffLink:
    """Wrap a fresh connection: run the Noise handshake when the link is
    configured encrypted (requires the `cryptography` dependency),
    otherwise plaintext envelopes."""
    session = None
    if cfg.encrypt:
        from symmetry_tpu_torch.identity import (
            Identity,
            client_handshake,
            server_handshake,
        )

        ident = Identity.from_name(cfg.secret or "disagg-link")
        expected = bytes.fromhex(cfg.peer_key) if cfg.peer_key else None
        hs = client_handshake if initiator else server_handshake
        try:
            session = await hs(conn, ident, expected)
        except Exception:
            await conn.close()
            raise
    return HandoffLink(conn, session)


# ---------------------------------------------------------------- config


class LinkConfig:
    """The `tpu.disagg` link settings (all optional; `peer` on the
    decode/provider side or `listen` on the prefill-node side selects
    network mode)."""

    def __init__(self, disagg: dict[str, Any] | None) -> None:
        d = disagg or {}
        self._raw: dict[str, Any] = dict(d)
        self.peer: str | None = d.get("peer")
        self.listen: str | None = d.get("listen")
        # Stable per-link identity announced in the hello (pool
        # membership); defaults to the bound/dialed address when unset.
        self.node_id: str | None = d.get("node_id")
        # Link keepalive (pool mode): the decode side pings every
        # heartbeat_s and DROPS a link silent for ~2 periods — a wedged
        # peer becomes a membership-churn event instead of a hang. 0
        # (the pair default) disables it.
        self.heartbeat_s: float = float(d.get("heartbeat_s", 0.0))
        # inline: the backend self-hosts the PrefillNode in-process and
        # dials it at `peer` — the full wire path (chunking, credit,
        # acks, reconnect) in one provider process. Benches, smokes, and
        # tests run this; production runs the node on its own machine.
        self.inline: bool = bool(d.get("inline", False))
        # Clamped to [4 KiB, MAX_CHUNK_BYTES]: chunk_kb 0 would make the
        # sender's range() step zero, and a chunk over the cap would not
        # fit one TCP-layer frame.
        self.chunk_bytes: int = min(max(
            int(d.get("chunk_kb", DEFAULT_CHUNK_BYTES // 1024)) * 1024,
            4096), MAX_CHUNK_BYTES)
        self.credit_bytes: int = max(int(
            float(d.get("credit_mb",
                        DEFAULT_CREDIT_BYTES / 2**20)) * 2**20),
            self.chunk_bytes)
        self.ack_timeout_s: float = float(
            d.get("ack_timeout_s", DEFAULT_ACK_TIMEOUT_S))
        self.max_retries: int = int(d.get("max_retries",
                                          DEFAULT_MAX_RETRIES))
        self.reconnect_base_s: float = float(
            d.get("reconnect_base_s", DEFAULT_RECONNECT_BASE_S))
        self.reconnect_max_s: float = float(
            d.get("reconnect_max_s", DEFAULT_RECONNECT_MAX_S))
        self.encrypt: bool = bool(d.get("encrypt", False))
        self.secret: str | None = d.get("secret")
        self.peer_key: str | None = d.get("peer_key")

    @property
    def network_mode(self) -> bool:
        return self.peer is not None

    def for_peer(self, peer: str, **overrides: Any) -> "LinkConfig":
        """A member-link config: this config with `peer` (and any
        per-member overrides, e.g. heartbeat_s) replaced — how the pool
        derives M per-member links from one `tpu.disagg` mapping."""
        return LinkConfig({**self._raw, "peer": peer, **overrides})


_MEM_HUB = None


def link_transport(address: str) -> Transport:
    """Transport by link-address scheme. `mem://` resolves against ONE
    process-global hub so an inline node and the backend (or a test's
    two endpoints) find each other without plumbing a hub instance."""
    if address.startswith("mem://"):
        global _MEM_HUB
        if _MEM_HUB is None:
            from symmetry_tpu_torch.transport.memory import MemoryTransport

            _MEM_HUB = MemoryTransport()
        return _MEM_HUB
    if address.startswith("tcp://"):
        from symmetry_tpu_torch.transport.tcp import TcpTransport

        return TcpTransport()
    raise ValueError(f"unsupported link address {address!r} "
                     f"(want tcp:// or mem://)")


# ----------------------------------------------------------- flow control


class CreditGate:
    """Sender-side byte window. `acquire(n)` blocks while the window is
    exhausted (that stall IS the cross-machine backpressure — it
    propagates through the node's serial pump into the prefill host's
    stdout pipe and from there into the scheduler's handoff sink);
    `grant(n)` returns consumed bytes from the receiver's credit
    messages."""

    def __init__(self, window: int) -> None:
        self._credit = window
        self._waiter: asyncio.Future | None = None
        self.stats = {"credit_stalls": 0, "credit_stall_s": 0.0}
        self._m_stalls = METRICS.counter(
            MetricName.LINK_CREDIT_STALLS,
            "sender stalls on an exhausted credit window")

    @property
    def available(self) -> int:
        return self._credit

    def grant(self, n: int) -> None:
        self._credit += n
        if self._waiter is not None and not self._waiter.done():
            self._waiter.set_result(None)

    def reset(self, window: int) -> None:
        """Resync to a known in-flight-zero point. Transfers are serial
        and always end in ack/nak/timeout, so at each transfer-attempt
        START no legitimate chunk bytes are outstanding — any credit
        deficit at that moment is LEAKED window (a chunk dropped by the
        wire or a fault seam consumed credit the receiver never saw and
        can never grant back). Without this, lossy-seam chaos drills
        shrink the window monotonically until acquire() wedges forever."""
        self._credit = window
        if self._waiter is not None and not self._waiter.done():
            self._waiter.set_result(None)

    async def acquire(self, n: int) -> None:
        stalled_at = None
        while self._credit < n:
            if stalled_at is None:
                stalled_at = time.monotonic()
                self.stats["credit_stalls"] += 1
                self._m_stalls.inc()
            self._waiter = asyncio.get_running_loop().create_future()
            await self._waiter
        if stalled_at is not None:
            self.stats["credit_stall_s"] += time.monotonic() - stalled_at
        self._credit -= n


# ------------------------------------------------------------- reassembly


class Reassembler:
    """Decode-side chunk reassembly, keyed by transfer id so a
    retransmit under a fresh id can never interleave with a stale
    attempt's chunks. Completion hands back length-checked bytes whose
    CRC the `end` header pins — a partial or corrupt transfer raises
    and is discarded; nothing partial ever leaves this class."""

    def __init__(self) -> None:
        self._bufs: dict[str, dict[str, Any]] = {}
        self.stats = {"partial_discards": 0, "stale_chunks": 0}
        self._m_partials = METRICS.counter(
            MetricName.LINK_PARTIAL_DISCARDS,
            "partial/corrupt transfers discarded (never adopted)")

    def _discard(self, n: int = 1) -> None:
        self.stats["partial_discards"] += n
        self._m_partials.inc(n)

    @property
    def active(self) -> int:
        return len(self._bufs)

    def begin(self, header: dict[str, Any]) -> None:
        xfer = str(header.get("xfer", ""))
        total = int(header.get("len", -1))
        if not xfer or total < 0:
            raise LinkError(f"malformed begin header: {header}")
        if total > MAX_TRANSFER_BYTES:
            raise LinkError(f"transfer claims {total} bytes, over the "
                            f"{MAX_TRANSFER_BYTES}-byte bound")
        if len(self._bufs) >= MAX_ACTIVE_TRANSFERS:
            # Senders are serial; piling up transfers is a protocol
            # violation. Evict the oldest — its sender retries or fails.
            stale = next(iter(self._bufs))
            self._bufs.pop(stale)
            self._discard()
        self._bufs[xfer] = {"buf": bytearray(), "total": total,
                            "next_seq": 0, "meta": header}

    def chunk(self, header: dict[str, Any], payload: bytes) -> bool:
        """Append one chunk; False when the transfer is unknown/stale
        (late chunks of an aborted attempt — credit is still granted by
        the caller so abandoned bytes never leak window)."""
        entry = self._bufs.get(str(header.get("xfer", "")))
        if entry is None:
            self.stats["stale_chunks"] += 1
            return False
        if int(header.get("seq", -1)) != entry["next_seq"]:
            # Out-of-order over an ordered transport = protocol bug or
            # corruption; kill the attempt, let the retry fix it.
            self._bufs.pop(str(header.get("xfer", "")), None)
            self._discard()
            raise LinkError(
                f"chunk seq {header.get('seq')} != expected "
                f"{entry['next_seq']}")
        entry["next_seq"] += 1
        entry["buf"] += payload
        if len(entry["buf"]) > entry["total"]:
            self._bufs.pop(str(header.get("xfer", "")), None)
            self._discard()
            raise LinkError("transfer overflow: more chunk bytes than "
                            "the begin header promised")
        return True

    def end(self, header: dict[str, Any]) -> tuple[dict, bytes]:
        """Complete a transfer → (begin meta, verified frame bytes).
        Raises LinkError on any mismatch (caller naks; sender retries)."""
        xfer = str(header.get("xfer", ""))
        entry = self._bufs.pop(xfer, None)
        if entry is None:
            raise LinkError(f"end for unknown transfer {xfer!r}")
        buf = bytes(entry["buf"])
        if len(buf) != entry["total"]:
            self._discard()
            raise LinkError(f"transfer truncated: {len(buf)} of "
                            f"{entry['total']} bytes")
        crc = int(header.get("crc", -1))
        if zlib.crc32(buf) != crc:
            self._discard()
            raise LinkError("transfer checksum mismatch")
        return entry["meta"], buf

    def abort_all(self) -> int:
        """Link died: discard every partial buffer. Returns the count —
        each was a handoff mid-flight whose request the caller sheds."""
        n = len(self._bufs)
        self._discard(n)
        self._bufs.clear()
        return n


# ----------------------------------------------------------------- sender


class HandoffSender:
    """Prefill-node side of the bulk path: one serial, credit-gated,
    acked transfer per handoff frame (see module docstring for why
    serial = the backpressure contract)."""

    def __init__(self, link: HandoffLink, gate: CreditGate,
                 cfg: LinkConfig, window: int | None = None) -> None:
        self._link = link
        self._gate = gate
        self._cfg = cfg
        self._window = window if window is not None else cfg.credit_bytes
        # (xfer) -> future resolved True by ack, False by nak
        self._acks: dict[str, asyncio.Future] = {}
        self.stats = {"handoffs_sent": 0, "handoff_bytes_sent": 0,
                      "retries": 0, "failed": 0}
        self._m_retries = METRICS.counter(
            MetricName.LINK_RETRIES,
            "handoff transfer retransmissions performed")

    def on_ack(self, header: dict[str, Any], ok: bool) -> None:
        fut = self._acks.get(str(header.get("xfer", "")))
        if fut is not None and not fut.done():
            fut.set_result(ok)

    def fail_all(self) -> None:
        """Link died: every in-flight ack wait resolves as failed."""
        for fut in self._acks.values():
            if not fut.done():
                fut.set_result(False)

    async def send_handoff(self, meta: dict[str, Any],
                           frame: bytes) -> bool:
        """Ship one frame; True once the decode node acked full
        reassembly + forwarding. False = retries exhausted or the link
        died mid-transfer (the decode side sheds the request; a best-
        effort `fail` tells it not to wait for the ack timeout)."""
        req_id = str(meta.get("id", ""))
        for attempt in range(1, self._cfg.max_retries + 2):
            xfer = uuid.uuid4().hex[:12]
            fut: asyncio.Future = \
                asyncio.get_running_loop().create_future()
            self._acks[xfer] = fut
            try:
                ok = await self._attempt(meta, frame, xfer, attempt, fut)
            except LinkError:
                self._acks.pop(xfer, None)
                self.stats["failed"] += 1
                return False  # link is gone; reconnect path owns recovery
            finally:
                self._acks.pop(xfer, None)
            if ok:
                self.stats["handoffs_sent"] += 1
                self.stats["handoff_bytes_sent"] += len(frame)
                return True
            retrying = attempt <= self._cfg.max_retries
            if retrying:
                # retries counts RETRANSMISSIONS actually performed —
                # the stat the bench reads as wasted wire work.
                self.stats["retries"] += 1
                self._m_retries.inc()
            log.warning(f"handoff {req_id} attempt {attempt} "
                        f"unacked/nak'd; "
                        f"{'retrying' if retrying else 'giving up'}")
        self.stats["failed"] += 1
        try:
            await self._link.send({"op": LinkOp.FAIL, "id": req_id,
                                   "reason": "handoff retries exhausted"})
        except LinkError:
            pass
        return False

    async def _attempt(self, meta: dict[str, Any], frame: bytes,
                       xfer: str, attempt: int,
                       fut: asyncio.Future) -> bool:
        # Transfer boundary = in-flight zero: clamp any credit leaked
        # by dropped chunks (see CreditGate.reset).
        self._gate.reset(self._window)
        begin = {**meta, "op": LinkOp.BEGIN, "xfer": xfer,
                 "len": len(frame), "attempt": attempt,
                 "t": time.monotonic()}
        await self._link.send(begin)
        step = self._cfg.chunk_bytes
        for seq, off in enumerate(range(0, len(frame), step)):
            if fut.done():
                # Early nak (the receiver killed this attempt on a seq/
                # overflow error): stop burning wire on a dead transfer.
                # (Already resolved — the await returns immediately.)
                return bool(await fut)
            try:
                # Bounded: ack_timeout_s only arms after END, so a
                # credit stall from leaked window (lossy seams dropping
                # CHUNK/CREDIT messages) would otherwise wedge HERE
                # forever — time it out into a failed attempt; the next
                # attempt's gate reset reclaims the leaked window.
                await asyncio.wait_for(
                    self._gate.acquire(min(step, len(frame) - off)),
                    self._cfg.ack_timeout_s)
            except asyncio.TimeoutError:
                return False
            await self._link.send(
                {"op": LinkOp.CHUNK, "xfer": xfer, "seq": seq},
                frame[off:off + step])
            if seq == 0 and FAULTS.enabled \
                    and FAULTS.point("disagg.net.drop_link"):
                # Deterministic mid-handoff cable pull: begin + one
                # chunk are on the wire, the rest never arrives. One
                # hit per transfer attempt, so @nth=N targets the Nth
                # handoff attempt exactly.
                await self._link.drop("injected drop_link fault")
                raise LinkError("link dropped by fault injection")
        await self._link.send({"op": LinkOp.END, "xfer": xfer,
                               "crc": zlib.crc32(frame)})
        try:
            return bool(await asyncio.wait_for(
                fut, self._cfg.ack_timeout_s))
        except asyncio.TimeoutError:
            return False


# -------------------------------------------------------- clock handshake


async def link_clock_handshake(link: HandoffLink,
                               rounds: int = CLOCK_ROUNDS) -> float:
    """Measure the peer's monotonic-clock offset over the link (dialer
    side, before the pump starts — replies are read inline). Same
    min-RTT NTP-midpoint estimate as the host pipe handshake; returns
    `offset = peer_clock - local_clock`."""
    from symmetry_tpu_torch.utils.trace import clock_handshake_offset

    samples: list[tuple[float, float, float]] = []
    deferred: list[tuple[dict[str, Any], bytes]] = []
    try:
        for _ in range(rounds):
            t0 = time.monotonic()
            await link.send({"op": LinkOp.CLOCK, "t0": t0})
            while True:
                msg = await link.recv()
                if msg is None:
                    raise LinkError("link died during clock handshake")
                header, payload = msg
                if header.get("op") == LinkOp.CLOCK \
                        and header.get("t0") == t0:
                    samples.append((t0, float(header["t"]),
                                    time.monotonic()))
                    break
                # The peer's side of the link is live before our rounds
                # finish (the node serves the moment it replies hello):
                # an event/fail/begin arriving here belongs to the pump
                # — defer it, never discard it.
                deferred.append((header, payload))
    finally:
        if deferred:
            link.requeue(deferred)
    return clock_handshake_offset(samples)


# ------------------------------------------------------------ decode side


class DecodeLink:
    """The decode/provider node's end: dial `tpu.disagg.peer`, keep the
    link alive with exponential-backoff reconnects, pump inbound
    messages, reassemble handoff transfers, and ack only after the
    frame has been handed to the decode host.

    Callbacks (all run on the owner's event loop):
      on_handoff(meta, frame)  awaited with the begin meta + verified
                               frame bytes; raising → nak (sender
                               retries); returning → ack
      on_event(ev)             a prefill-tier terminal event dict
      on_fail(req_id, reason)  handoff abandoned by the sender
      on_down(reason)          the link just died; in-flight migrations
                               must shed (reconnect is automatic)
      on_up()                  link (re)connected and clock-synced
      on_drain(node)           peer announced a deliberate drain: stop
                               NEW placements; in-flight work finishes
      on_leave(node)           peer announced departure (membership
                               churn, not a fault)
    """

    def __init__(self, cfg: LinkConfig, *,
                 on_handoff: Callable[[dict, bytes], Awaitable[None]],
                 on_event: Callable[[dict], None],
                 on_fail: Callable[[str, str], None],
                 on_down: Callable[[str], None],
                 on_up: Callable[[], None] | None = None,
                 on_drain: Callable[[str], None] | None = None,
                 on_leave: Callable[[str], None] | None = None) -> None:
        self.cfg = cfg
        self._on_handoff = on_handoff
        self._on_event = on_event
        self._on_fail = on_fail
        self._on_down = on_down
        self._on_up = on_up
        self._on_drain = on_drain
        self._on_leave = on_leave
        # Peer-announced identity off the hello ("node") — the pool
        # router's member naming; falls back to the dialed address.
        self.peer_node: str | None = None
        self._last_rx = 0.0
        self._hb_task: asyncio.Task | None = None
        self._transport = link_transport(cfg.peer)
        self._link: HandoffLink | None = None
        self._reasm = Reassembler()
        self._task: asyncio.Task | None = None
        self._connected = asyncio.Event()
        self._stopped = False
        self.clock_offset = 0.0
        # (op) -> waiters for stats/trace probe replies over the link
        self._waiters: dict[str, list[asyncio.Future]] = {
            LinkOp.STATS: [], LinkOp.TRACE: []}
        self.stats = {"connects": 0, "drops": 0, "wire_frames": 0,
                      "wire_bytes": 0}
        self._m_connects = METRICS.counter(
            MetricName.LINK_CONNECTS, "handoff link connects")
        self._m_drops = METRICS.counter(
            MetricName.LINK_DROPS, "handoff link drops")
        # Peer-labeled: a pool runs one DecodeLink per member, and an
        # unlabeled gauge would be clobbered by whichever link moved
        # last. The pair gets one series; symtop sums across peers.
        self._m_connected = METRICS.gauge(
            MetricName.LINK_CONNECTED, "handoff link up (1) / down (0)",
            labels=("peer",))
        self._m_wire_frames = METRICS.counter(
            MetricName.LINK_WIRE_FRAMES,
            "complete handoff frames received off the link")
        self._m_wire_bytes = METRICS.counter(
            MetricName.LINK_WIRE_BYTES,
            "handoff frame bytes received off the link")

    # -------------------------------------------------------- lifecycle

    async def start(self, *, wait_s: float | None = None) -> None:
        """Begin the connect/pump loop; optionally block until the
        first successful connect (startup wants the link proven)."""
        self._task = asyncio.get_running_loop().create_task(
            self._run())
        if wait_s is not None:
            try:
                await asyncio.wait_for(self._connected.wait(), wait_s)
            except asyncio.TimeoutError:
                raise LinkError(
                    f"handoff link to {self.cfg.peer} not up within "
                    f"{wait_s:.0f}s") from None

    async def stop(self) -> None:
        import contextlib

        self._stopped = True
        if self._hb_task is not None:
            self._hb_task.cancel()
            self._hb_task = None
        if self._task is not None:
            self._task.cancel()
            with contextlib.suppress(asyncio.CancelledError):
                await self._task
            self._task = None
        if self._link is not None:
            await self._link.close()
            self._link = None

    @property
    def connected(self) -> bool:
        return (self._connected.is_set() and self._link is not None
                and not self._link.closed)

    @property
    def reassembly_stats(self) -> dict[str, int]:
        return dict(self._reasm.stats)

    # ------------------------------------------------------------- sends

    async def _send(self, header: dict[str, Any],
                    payload: bytes = b"") -> None:
        link = self._link
        if link is None or not self._connected.is_set():
            raise LinkError("handoff link down")
        await link.send(header, payload)

    async def submit(self, op: dict[str, Any]) -> None:
        """Forward one host submit op to the prefill node (payload =
        the JSON line the node splices onto its host's stdin)."""
        await self._send({"op": LinkOp.SUBMIT},
                         json.dumps(op, separators=(",", ":")).encode())

    async def cancel(self, op: dict[str, Any]) -> None:
        await self._send({"op": LinkOp.CANCEL},
                         json.dumps(op, separators=(",", ":")).encode())

    async def probe(self, op: str, timeout: float = 10.0) -> dict | None:
        """stats/trace round-trip over the link; None on timeout or a
        down link (mirrors the backend's host-pipe probes)."""
        if op not in self._waiters:
            raise ValueError(f"unknown link probe {op!r}")
        fut: asyncio.Future = asyncio.get_running_loop().create_future()
        self._waiters[op].append(fut)
        # Spelled as two literal headers (not {"op": op}) so the symlint
        # wire-contract checker sees the producer side of both ops.
        header = ({"op": LinkOp.STATS} if op == LinkOp.STATS
                  else {"op": LinkOp.TRACE})
        try:
            try:
                await self._send(header)
            except LinkError:
                return None
            return await asyncio.wait_for(fut, timeout)
        except asyncio.TimeoutError:
            return None
        finally:
            if fut in self._waiters[op]:
                self._waiters[op].remove(fut)

    # -------------------------------------------------------------- pump

    async def _run(self) -> None:
        backoff = self.cfg.reconnect_base_s
        while not self._stopped:
            try:
                conn = await self._transport.dial(self.cfg.peer)
                link = await secure_link(conn, self.cfg, initiator=True)
            except Exception as exc:  # noqa: BLE001 — any dial failure
                log.warning(f"handoff link dial {self.cfg.peer} failed: "
                            f"{exc}; retrying in {backoff:.1f}s")
                await asyncio.sleep(backoff)
                backoff = min(backoff * 2, self.cfg.reconnect_max_s)
                continue
            try:
                await link.send({"op": LinkOp.HELLO,
                                 "version": LINK_VERSION,
                                 "role": "decode",
                                 "node": self.cfg.node_id or "",
                                 "window": self.cfg.credit_bytes})
                msg = await link.recv()
                if msg is None or msg[0].get("op") != LinkOp.HELLO:
                    raise LinkError("no hello from prefill node")
                if int(msg[0].get("version", 0)) != LINK_VERSION:
                    raise LinkError(
                        f"link version mismatch: peer speaks "
                        f"{msg[0].get('version')}, this build "
                        f"{LINK_VERSION}")
                self.peer_node = (str(msg[0].get("node") or "")
                                  or self.cfg.peer)
                self.clock_offset = await link_clock_handshake(link)
            except Exception as exc:  # noqa: BLE001 — handshake failure
                await link.close()
                log.warning(f"handoff link handshake failed: {exc}; "
                            f"retrying in {backoff:.1f}s")
                await asyncio.sleep(backoff)
                backoff = min(backoff * 2, self.cfg.reconnect_max_s)
                continue
            backoff = self.cfg.reconnect_base_s
            self._link = link
            self._connected.set()
            self.stats["connects"] += 1
            self._m_connects.inc()
            self._m_connected.set(1, peer=self.cfg.peer or "")
            log.info(f"handoff link up: {link.remote_address} "
                     f"clock_offset={self.clock_offset * 1e6:+.0f}us")
            if self._on_up is not None:
                self._on_up()
            self._last_rx = time.monotonic()
            if self.cfg.heartbeat_s > 0:
                self._hb_task = asyncio.get_running_loop().create_task(
                    self._heartbeat(link))
            try:
                reason = await self._pump(link)
            except Exception as exc:  # noqa: BLE001 — a malformed header
                # (non-numeric len/seq/crc…) must drop the LINK and
                # reconnect, never silently kill this task while
                # _connected stays set and every stream hangs.
                reason = f"link pump error: {exc!r}"
            if self._hb_task is not None:
                self._hb_task.cancel()
                self._hb_task = None
            self._connected.clear()
            self._link = None
            self.stats["drops"] += 1
            self._m_drops.inc()
            self._m_connected.set(0, peer=self.cfg.peer or "")
            shed = self._reasm.abort_all()
            for lst in self._waiters.values():
                for fut in lst:
                    if not fut.done():
                        fut.set_result(None)
                lst.clear()
            await link.close()
            if self._stopped:
                return
            log.warning(f"handoff link down ({reason}); {shed} partial "
                        f"transfer(s) discarded; reconnecting")
            self._on_down(reason)

    async def _heartbeat(self, link: HandoffLink) -> None:
        """Keepalive pings (pool mode). ANY inbound traffic counts as
        liveness (_last_rx is stamped by the pump); a link silent for
        ~2 periods is cut here — the pump sees the close, the down path
        sheds, and the reconnect loop owns recovery. A wedged-but-
        connected peer thus becomes ordinary membership churn."""
        period = self.cfg.heartbeat_s
        while not link.closed:
            await asyncio.sleep(period)
            silent = time.monotonic() - self._last_rx
            if silent > 2 * period:
                await link.drop(
                    f"keepalive: no traffic for {silent:.1f}s")
                return
            try:
                await link.send({"op": LinkOp.PING,
                                 "t": time.monotonic()})
            except LinkError:
                return  # pump is already tearing the link down

    async def _pump(self, link: HandoffLink) -> str:
        while True:
            try:
                msg = await link.recv()
            except LinkError as exc:
                return str(exc)
            if msg is None:
                return "link EOF"
            self._last_rx = time.monotonic()
            header, payload = msg
            op = header.get("op")
            try:
                if op == LinkOp.CHUNK:
                    # Credit returns whether the chunk lands, is stale,
                    # or fails integrity — abandoned attempts must not
                    # leak window.
                    await link.send({"op": LinkOp.CREDIT,
                                     "n": len(payload)})
                    self._reasm.chunk(header, payload)
                elif op == LinkOp.BEGIN:
                    self._reasm.begin(header)
                elif op == LinkOp.END:
                    await self._complete(link, header)
                elif op == LinkOp.EVENT:
                    ev = _json_payload(payload)
                    if ev is not None:
                        self._on_event(ev)
                elif op == LinkOp.FAIL:
                    self._on_fail(str(header.get("id", "")),
                                  str(header.get("reason", "")))
                elif op in (LinkOp.STATS, LinkOp.TRACE):
                    reply = _json_payload(payload)
                    waiters, self._waiters[op] = self._waiters[op], []
                    for fut in waiters:
                        if not fut.done():
                            fut.set_result(reply)
                elif op == LinkOp.DRAIN:
                    if self._on_drain is not None:
                        self._on_drain(str(header.get("node", "")))
                elif op == LinkOp.LEAVE:
                    if self._on_leave is not None:
                        self._on_leave(str(header.get("node", "")))
                elif op == LinkOp.PONG:
                    pass  # liveness already stamped by _last_rx above
                elif op == LinkOp.CLOCK:
                    # Stray post-handshake probe echo; ignore.
                    pass
                elif op == LinkOp.HELLO:
                    pass
                else:
                    return f"unknown link op {op!r}"
            except LinkError as exc:
                # Reassembly integrity failure: nak THIS transfer (the
                # sender retries under a fresh id); the link survives.
                xfer = str(header.get("xfer", ""))
                log.warning(f"handoff transfer {xfer} failed: {exc}")
                try:
                    await link.send({"op": LinkOp.NAK, "xfer": xfer,
                                     "reason": str(exc)})
                except LinkError as exc2:
                    return str(exc2)

    async def _complete(self, link: HandoffLink,
                        header: dict[str, Any]) -> None:
        meta, frame = self._reasm.end(header)  # raises LinkError → nak
        t_emit = meta.get("t")
        if t_emit is not None:
            # The wire leg on THIS machine's clock: sender stamp mapped
            # through the measured link offset. Sub-RTT jitter can make
            # it microsecond-negative; clamp for the histogram.
            wire_s = max(
                time.monotonic() - (float(t_emit) - self.clock_offset),
                0.0)
            meta = {**meta, "wire_s": wire_s}
        self.stats["wire_frames"] += 1
        self.stats["wire_bytes"] += len(frame)
        self._m_wire_frames.inc()
        self._m_wire_bytes.inc(len(frame))
        xfer = str(header.get("xfer", ""))
        try:
            await self._on_handoff(meta, frame)
        except Exception as exc:  # noqa: BLE001 — adoption-side failure
            raise LinkError(f"handoff forward failed: {exc}") from exc
        await link.send({"op": LinkOp.ACK, "xfer": xfer})


def _json_payload(payload: bytes) -> dict | None:
    try:
        obj = json.loads(payload)
    except ValueError:
        return None
    return obj if isinstance(obj, dict) else None


# ----------------------------------------------------------- prefill side


class PrefillLink:
    """The prefill node's end of ONE accepted connection: hello reply,
    clock echoes, command forwarding, and the sender-side bulk path.
    The node accepts one live link at a time (a reconnect replaces the
    old connection); `serve()` returns on EOF.

    Callbacks:
      on_command(line: bytes)      awaited with one host-pipe JSON line
                                   (submit/cancel) to splice onto the
                                   prefill host's stdin
      on_probe(op) -> dict|None    awaited for stats/trace probes;
                                   the reply rides back over the link
    """

    def __init__(self, link: HandoffLink, cfg: LinkConfig, *,
                 on_command: Callable[[bytes], Awaitable[None]],
                 on_probe: Callable[[str], Awaitable[dict | None]],
                 node_id: str | None = None) -> None:
        self._link = link
        self._cfg = cfg
        self._on_command = on_command
        self._on_probe = on_probe
        # Identity announced in the hello reply — the pool router's
        # member naming for this node.
        self.node_id = node_id or cfg.node_id or ""
        self.peer_node: str | None = None  # dialer's announced identity
        # Window starts at the peer's advertised hello value; replaced
        # in handshake().
        self._gate = CreditGate(cfg.credit_bytes)
        self.sender = HandoffSender(link, self._gate, cfg)
        # Probe replies run OFF the pump (strong refs — the loop holds
        # tasks weakly): a stats round-trip to the host can take
        # seconds, and awaiting it inline would stop CREDIT/ACK
        # processing — deadlocking against the node's host pump, which
        # may itself be blocked inside send_handoff waiting for those
        # very grants while it alone can read the host's stats reply.
        self._probe_tasks: set[asyncio.Task] = set()

    @property
    def closed(self) -> bool:
        return self._link.closed

    async def handshake(self, timeout: float = 30.0) -> None:
        """Expect the dialer's hello; reply with ours. The dialer's
        advertised window seeds the credit gate."""
        async def _hello() -> None:
            msg = await self._link.recv()
            if msg is None or msg[0].get("op") != LinkOp.HELLO:
                raise LinkError("dialer sent no hello")
            if int(msg[0].get("version", 0)) != LINK_VERSION:
                raise LinkError(
                    f"link version mismatch: peer speaks "
                    f"{msg[0].get('version')}, this build {LINK_VERSION}")
            window = int(msg[0].get("window", self._cfg.credit_bytes))
            self.peer_node = str(msg[0].get("node") or "") or None
            self._gate = CreditGate(window)
            self.sender = HandoffSender(self._link, self._gate,
                                        self._cfg, window=window)
            await self._link.send({"op": LinkOp.HELLO,
                                   "version": LINK_VERSION,
                                   "role": "prefill",
                                   "node": self.node_id,
                                   "window": window})

        await asyncio.wait_for(_hello(), timeout)

    async def send_handoff(self, meta: dict[str, Any],
                           frame: bytes) -> bool:
        return await self.sender.send_handoff(meta, frame)

    async def send_event(self, ev: dict[str, Any]) -> None:
        await self._link.send(
            {"op": LinkOp.EVENT},
            json.dumps(ev, separators=(",", ":")).encode())

    async def send_drain(self) -> None:
        """Announce a deliberate drain: the decode side's pool router
        stops placing NEW work here; in-flight requests finish."""
        await self._link.send({"op": LinkOp.DRAIN, "node": self.node_id})

    async def send_leave(self) -> None:
        """Announce departure (drain complete / shutdown): membership
        churn the router accounts, not a fault it recovers from."""
        await self._link.send({"op": LinkOp.LEAVE, "node": self.node_id})

    async def serve(self) -> str:
        """Inbound pump until the link dies; returns the reason."""
        link = self._link
        while True:
            try:
                msg = await link.recv()
            except LinkError as exc:
                return str(exc)
            if msg is None:
                return "link EOF"
            header, payload = msg
            op = header.get("op")
            if op == LinkOp.CREDIT:
                self._gate.grant(int(header.get("n", 0)))
            elif op == LinkOp.ACK:
                self.sender.on_ack(header, True)
            elif op == LinkOp.NAK:
                self.sender.on_ack(header, False)
            elif op in (LinkOp.SUBMIT, LinkOp.CANCEL):
                try:
                    await self._on_command(payload)
                except Exception as exc:  # noqa: BLE001 — host pipe down
                    log.warning(f"link command forward failed: {exc}")
            elif op == LinkOp.CLOCK:
                try:
                    await link.send({"op": LinkOp.CLOCK,
                                     "t0": header.get("t0"),
                                     "t": time.monotonic()})
                except LinkError as exc:
                    return str(exc)
            elif op == LinkOp.PING:
                try:
                    await link.send({"op": LinkOp.PONG,
                                     "t": header.get("t")})
                except LinkError as exc:
                    return str(exc)
            elif op in (LinkOp.STATS, LinkOp.TRACE):
                task = asyncio.ensure_future(self._probe_reply(op))
                self._probe_tasks.add(task)
                task.add_done_callback(self._probe_tasks.discard)
            elif op == LinkOp.HELLO:
                pass  # duplicate hello: harmless
            else:
                return f"unknown link op {op!r}"

    async def _probe_reply(self, op: str) -> None:
        reply = await self._on_probe(op)
        reply_header = ({"op": LinkOp.STATS} if op == LinkOp.STATS
                        else {"op": LinkOp.TRACE})
        try:
            await self._link.send(
                reply_header,
                json.dumps(reply or {}, separators=(",", ":")).encode())
        except LinkError:
            pass  # link died; the serve pump is already exiting

    def fail_inflight(self) -> None:
        self.sender.fail_all()

    async def close(self) -> None:
        for task in list(self._probe_tasks):
            task.cancel()
        await self._link.close()

    def stats(self) -> dict[str, Any]:
        return {**self.sender.stats, **self._gate.stats,
                "link": dict(self._link.stats)}
