"""NAT traversal: rendezvous-assisted UDP hole punching for udpstream.

The reference's providers are reachable behind NAT via hyperdht's
holepunching (dep hyperdht 6.15.4; swarm join at reference
src/provider.ts:38-49 — the capability its readme's architecture sells).
This is the TPU-era equivalent over our native transport:

  - Every udpstream ctx (native/udpstream/udpstream.cpp) carries an F_RAW
    side channel: connectionless datagrams from the SAME socket the
    stream protocol uses, so a raw packet opens exactly the NAT mapping
    a later stream will traverse (transport/udp.py RawChannel).
  - A rendezvous service (PunchRendezvous, typically co-located with the
    Symmetry server) observes each provider's REFLEXIVE address from its
    periodic `register` datagrams.
  - A client asks the rendezvous for a provider (`request`); the
    rendezvous tells the client the provider's reflexive address (`peer`)
    and simultaneously tells the provider the client's (`invite`).
  - Both sides burst `punch` datagrams at each other: each burst opens
    the sender's own NAT pinhole outward, so the other side's packets —
    and then the client's us_dial SYNs — pass. Simultaneous-open is safe
    at the stream layer: an inbound SYN on a dialing ctx just queues a
    connection that is never accepted.
  - The client then dials `udp://reflexive` from the SAME ctx/port.

Wire format: JSON payloads in F_RAW frames. All messages are small and
connectionless; loss is handled by repetition (register re-sends on an
interval, request retries, punches burst).

Relay fallback (provider unreachable even after punching) lives at the
protocol layer instead: server-spliced end-to-end-encrypted relay
(server/broker.py RELAY_* keys) — see network/relay.py.
"""

from __future__ import annotations

import asyncio
import json
import struct
import time
from typing import Any

from symmetry_tpu_torch.utils.logging import logger

# F_RAW frame header (must match native/udpstream/udpstream.cpp pack_hdr):
# MAGIC, flags, conn_id u32, seq u32, ack u32, len u16 → 16 bytes.
_MAGIC = 0xD5
_F_RAW = 32
_HDR = struct.Struct("<BBIII H")  # 1+1+4+4+4+2 = 16

PUNCH_BURST = 6
PUNCH_INTERVAL_S = 0.25
REGISTER_INTERVAL_S = 20.0
ENTRY_TTL_S = 90.0


def wrap_raw(payload: bytes) -> bytes:
    """Frame a payload exactly like us_send_raw does — lets a plain
    asyncio UDP socket (the rendezvous) interoperate with udpstream's
    raw channel."""
    return _HDR.pack(_MAGIC, _F_RAW, 0, 0, 0, len(payload)) + payload


def unwrap_raw(packet: bytes) -> bytes | None:
    if len(packet) < _HDR.size:
        return None
    magic, flags, _, _, _, ln = _HDR.unpack_from(packet)
    if magic != _MAGIC or not flags & _F_RAW:
        return None
    return packet[_HDR.size:_HDR.size + ln]


def _msg(op: str, **kw: Any) -> bytes:
    return json.dumps({"op": op, **kw}).encode()


def resolve_endpoint(addr: tuple[str, int]) -> tuple[str, int]:
    """Resolve a (host, port) to an IPv4 literal once, up front: the raw
    channel (us_send_raw) takes only literals, and invite/peer source
    matching compares against inet_ntop output — a hostname would make
    both fail silently."""
    import socket

    host, port = addr
    try:
        return socket.gethostbyname(host), int(port)
    except OSError as exc:
        raise ConnectionError(
            f"cannot resolve rendezvous host {host!r}: {exc}") from exc


MAX_REGISTRY = 4096
REGISTER_SKEW_S = 90.0
# Source-address proof for `request` (round-3 advisor): UDP sources are
# spoofable, so an unauthenticated request would let an attacker point a
# provider's 6-packet punch burst at a victim (small reflection vector)
# and learn reflexive addresses. A requester must first echo a stateless
# cookie (keyed hash of its source address + time window) — proving it
# RECEIVES at the claimed source — before the rendezvous brokers a punch.
COOKIE_WINDOW_S = 30.0
# Per-source invite budget: even a cookie-proven source can't grind a
# provider with endless punch bursts.
MAX_INVITES_PER_SOURCE = 8
INVITE_WINDOW_S = 30.0
# Retransmissions of the same (source, key) dial within this window are
# answered but charged to the invite budget only once.
DIAL_DEDUP_S = 10.0


def _register_sig_msg(key_hex: str, ts: float) -> bytes:
    return json.dumps(["punch-register", key_hex, round(ts, 3)],
                      sort_keys=True, separators=(",", ":")).encode()


class PunchRendezvous:
    """The server-side endpoint: learns reflexive addresses, brokers
    punches. Plain asyncio UDP speaking F_RAW frames.

    Registrations are SIGNED with the provider's Ed25519 key (the same
    identity the data plane pins): provider keys are public, so an
    unsigned rendezvous would let anyone overwrite a provider's
    reflexive address and deny NAT traversal to it — the same spoofing
    class the DHT's signed announces close."""

    def __init__(self) -> None:
        import os

        self._registry: dict[str, tuple[tuple[str, int], float]] = {}
        # replay fence: last accepted signed ts per key — a captured
        # register datagram re-sent from another address must not move
        # the record
        self._last_ts: dict[str, float] = {}
        self._transport: asyncio.DatagramTransport | None = None
        self._cookie_secret = os.urandom(16)
        self._invites: dict[tuple[str, int], list[float]] = {}
        # (source addr, target key) -> last brokered ts (retransmission
        # dedup for the invite budget; see the `request` handler)
        self._recent_dials: dict[tuple[tuple[str, int], str], float] = {}

    async def start(self, host: str = "0.0.0.0", port: int = 0) -> None:
        loop = asyncio.get_running_loop()

        class _Proto(asyncio.DatagramProtocol):
            def datagram_received(proto, data: bytes, addr) -> None:
                self._on_datagram(data, addr)

        self._transport, _ = await loop.create_datagram_endpoint(
            _Proto, local_addr=(host, port))

    @property
    def port(self) -> int:
        assert self._transport is not None
        return self._transport.get_extra_info("sockname")[1]

    async def stop(self) -> None:
        if self._transport is not None:
            self._transport.close()

    def _send(self, payload: bytes, addr: tuple[str, int]) -> None:
        assert self._transport is not None
        self._transport.sendto(wrap_raw(payload), addr)

    def _on_datagram(self, data: bytes, addr: tuple[str, int]) -> None:
        payload = unwrap_raw(data)
        if payload is None:
            return
        try:
            msg = json.loads(payload.decode())
        except (ValueError, UnicodeDecodeError):
            return
        op = msg.get("op")
        if op == "register":
            key = str(msg.get("key", ""))[:128]
            if key and self._verify_register(key, msg):
                ts = float(msg.get("ts", 0))
                if ts <= self._last_ts.get(key, 0.0):
                    return  # replayed or out-of-order register
                if len(self._registry) >= MAX_REGISTRY:
                    now = time.monotonic()
                    self._registry = {
                        k: v for k, v in self._registry.items()
                        if v[1] + ENTRY_TTL_S > now}
                    self._last_ts = {k: t for k, t in self._last_ts.items()
                                     if k in self._registry}
                if len(self._registry) < MAX_REGISTRY:
                    self._last_ts[key] = ts
                    self._registry[key] = (addr, time.monotonic())
                    self._send(_msg("registered", addr=list(addr)), addr)
        elif op == "request":
            key = str(msg.get("key", ""))
            if not self._cookie_ok(str(msg.get("cookie", "")), addr):
                # Source unproven: answer with a cookie only. A spoofed
                # source never sees this reply, so it can never present
                # the cookie — no burst is ever pointed at a bystander.
                self._send(_msg("challenge", key=key,
                                cookie=self._cookie_for(addr)), addr)
                return
            entry = self._registry.get(key)
            if entry is None or entry[1] + ENTRY_TTL_S < time.monotonic():
                self._send(_msg("unknown", key=key), addr)
                return
            # Budget accounting: unknown-key probes never charge (the
            # lookup above short-circuits), and RETRANSMISSIONS of the
            # same (source, key) dial within a short window charge only
            # once — punch_dial resends every second while replies are
            # lost, one persistent dial socket serves all of a client's
            # dials (transport/udp.py), and charging each resend would
            # burn the whole window on a single lossy dial.
            now_m = time.monotonic()
            dial_key = (addr, key)
            last = self._recent_dials.get(dial_key, -1e9)
            is_retransmit = now_m - last < DIAL_DEDUP_S
            # Keep the FIRST-seen time: refreshing on every resend would
            # let a proven source stay "retransmitting" forever and never
            # be charged to the invite budget. With first-seen semantics a
            # sustained resender is re-charged once per DIAL_DEDUP_S
            # window, so MAX_INVITES_PER_SOURCE actually bounds the punch
            # bursts it can aim at a provider.
            if not is_retransmit:
                self._recent_dials[dial_key] = now_m
            if len(self._recent_dials) > MAX_REGISTRY:
                self._recent_dials = {
                    k: t for k, t in self._recent_dials.items()
                    if now_m - t < DIAL_DEDUP_S}
            if not is_retransmit and not self._invite_allowed(addr):
                # Proven source, but over its punch budget. Reply
                # explicitly (safe — the source is cookie-proven) so the
                # dialer fails fast instead of resending into silence.
                self._send(_msg("busy", key=key), addr)
                return
            target_addr = entry[0]
            # Tell the requester where the target is, AND the target where
            # the requester is — both start punching at once.
            self._send(_msg("peer", key=key, addr=list(target_addr)), addr)
            self._send(_msg("invite", addr=list(addr)), target_addr)
        # "punch"/"registered"/"peer"/"invite" arriving here are strays

    def _cookie_for(self, addr: tuple[str, int],
                    window_off: int = 0) -> str:
        import hashlib

        window = int(time.time() // COOKIE_WINDOW_S) + window_off
        return hashlib.blake2b(
            f"{addr[0]}|{addr[1]}|{window}".encode(),
            key=self._cookie_secret, digest_size=16).hexdigest()

    def _cookie_ok(self, cookie: str, addr: tuple[str, int]) -> bool:
        import hmac

        if not cookie:
            return False
        # current or previous window: a cookie issued just before a
        # window boundary must not bounce its echo
        return any(hmac.compare_digest(cookie, self._cookie_for(addr, off))
                   for off in (0, -1))

    def _invite_allowed(self, addr: tuple[str, int]) -> bool:
        now = time.monotonic()
        if len(self._invites) >= MAX_REGISTRY:  # bound the tracker itself
            self._invites = {
                a: ts for a, ts in self._invites.items()
                if ts and now - ts[-1] < INVITE_WINDOW_S}
        recent = [t for t in self._invites.get(addr, [])
                  if now - t < INVITE_WINDOW_S]
        if len(recent) >= MAX_INVITES_PER_SOURCE:
            self._invites[addr] = recent
            return False
        recent.append(now)
        self._invites[addr] = recent
        return True

    @staticmethod
    def _verify_register(key_hex: str, msg: dict) -> bool:
        from symmetry_tpu_torch.identity import Identity

        try:
            pub = bytes.fromhex(key_hex)
            sig = bytes.fromhex(str(msg.get("sig", "")))
            ts = float(msg.get("ts", 0))
        except (ValueError, TypeError):
            return False
        if abs(time.time() - ts) > REGISTER_SKEW_S:
            return False
        return Identity.verify(_register_sig_msg(key_hex, ts), sig, pub)


class ProviderPuncher:
    """Provider-side worker: keeps the provider registered at the
    rendezvous (through its LISTENER ctx, so the reflexive address maps
    the stream port) and answers invites with punch bursts."""

    def __init__(self, raw_channel, rendezvous: tuple[str, int],
                 identity) -> None:
        self._raw = raw_channel
        self._rdv = resolve_endpoint(rendezvous)
        self._identity = identity
        self._key = identity.public_hex
        self._task: asyncio.Task | None = None
        self.punched: int = 0  # invites answered (introspection/tests)

    def start(self) -> None:
        self._task = asyncio.get_running_loop().create_task(self._run())

    async def stop(self) -> None:
        if self._task is not None:
            self._task.cancel()
            try:
                await self._task
            except (asyncio.CancelledError, Exception):  # noqa: BLE001
                pass

    async def _run(self) -> None:
        next_register = 0.0
        while True:
            now = time.monotonic()
            if now >= next_register:
                ts = time.time()
                sig = self._identity.sign(
                    _register_sig_msg(self._key, ts)).hex()
                if not self._raw.send(
                        self._rdv[0], self._rdv[1],
                        _msg("register", key=self._key,
                             ts=round(ts, 3), sig=sig)):
                    logger.warning(
                        f"punch register send to {self._rdv} failed")
                next_register = now + REGISTER_INTERVAL_S
            got = await self._raw.recv(timeout_s=1.0)
            if got is None:
                continue
            payload, host, port = got
            msg = _parse(payload)
            if msg is None:
                continue
            if msg.get("op") == "invite" and (host, port) == self._rdv:
                addr = msg.get("addr") or []
                if len(addr) == 2:
                    self.punched += 1
                    # burst concurrently: serial bursts (1.5 s each) would
                    # stall invite handling for later clients past their
                    # punch deadline
                    task = asyncio.get_running_loop().create_task(
                        self._burst(str(addr[0]), int(addr[1])))
                    task.add_done_callback(lambda t: t.exception())
            # punches from clients need no reply: their arrival already
            # proves our pinhole is open, and ours open theirs

    async def _burst(self, host: str, port: int) -> None:
        for _ in range(PUNCH_BURST):
            self._raw.send(host, port, _msg("punch", key=self._key))
            await asyncio.sleep(PUNCH_INTERVAL_S)


def _parse(payload: bytes) -> dict | None:
    try:
        msg = json.loads(payload.decode())
    except (ValueError, UnicodeDecodeError):
        return None
    return msg if isinstance(msg, dict) else None


async def punch_dial(transport, rendezvous: tuple[str, int],
                     target_key_hex: str, *,
                     timeout_s: float = 8.0) -> str:
    """Client side: resolve + punch a provider through the rendezvous;
    returns the dialable `udp://host:port` address. The caller then dials
    it with the SAME transport — the dial leaves from the ctx whose
    pinhole the punches opened.

    Raises ConnectionError when the rendezvous doesn't know the key or
    nothing gets through within the timeout.
    """
    rendezvous = resolve_endpoint(rendezvous)
    raw = transport.dial_raw_channel()
    deadline = time.monotonic() + timeout_s
    peer_addr: tuple[str, int] | None = None
    cookie: str | None = None  # source-address proof (challenge echo)

    def _request() -> bool:
        body = {"key": target_key_hex}
        if cookie is not None:
            body["cookie"] = cookie
        return raw.send(rendezvous[0], rendezvous[1],
                        _msg("request", **body))

    if not _request():
        raise ConnectionError(f"cannot send to rendezvous {rendezvous}")
    last_req = time.monotonic()
    burst_task: asyncio.Task | None = None
    try:
        while time.monotonic() < deadline:
            got = await raw.recv(timeout_s=0.5)
            now = time.monotonic()
            if got is None:
                if peer_addr is None and now - last_req > 1.0:
                    _request()
                    last_req = now
                continue
            payload, host, port = got
            msg = _parse(payload)
            if msg is None:
                continue
            op = msg.get("op")
            if op == "challenge" and (host, port) == rendezvous:
                # Echo the cookie straight back: receiving it at our
                # claimed source IS the proof the rendezvous wants.
                cookie = str(msg.get("cookie", "")) or None
                _request()
                last_req = now
                continue
            if op == "unknown" and (host, port) == rendezvous:
                raise ConnectionError(
                    f"rendezvous does not know provider {target_key_hex[:12]}")
            if op == "busy" and (host, port) == rendezvous:
                raise ConnectionError(
                    "rendezvous rate-limited this source (invite budget); "
                    "back off before re-dialing")
            if op == "peer" and (host, port) == rendezvous:
                addr = msg.get("addr") or []
                if len(addr) == 2 and peer_addr is None:
                    peer_addr = (str(addr[0]), int(addr[1]))

                    async def _burst() -> None:
                        for _ in range(PUNCH_BURST):
                            raw.send(peer_addr[0], peer_addr[1],
                                     _msg("punch", key="client"))
                            await asyncio.sleep(PUNCH_INTERVAL_S)

                    burst_task = asyncio.get_running_loop().create_task(
                        _burst())
            elif op == "punch" and peer_addr is not None and (
                    host, port) == peer_addr:
                # provider's punch arrived: the path works both ways
                logger.debug(f"punch confirmed from {host}:{port}")
                return f"udp://{peer_addr[0]}:{peer_addr[1]}"
        if peer_addr is not None:
            # No punch seen (e.g. provider's confirm was lost) — the
            # pinholes may still be open; let the dial try.
            return f"udp://{peer_addr[0]}:{peer_addr[1]}"
        raise ConnectionError(
            f"no rendezvous answer for {target_key_hex[:12]} "
            f"within {timeout_s}s")
    finally:
        if burst_task is not None and not burst_task.done():
            burst_task.cancel()
