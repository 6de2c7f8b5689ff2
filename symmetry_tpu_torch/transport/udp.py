"""UDP stream transport: Python asyncio adapter over the C++ udpstream lib.

The reference's transport floor is udx-native — a C addon providing reliable
multiplexed UDP streams under every peer connection (SURVEY §2.2). This is
its equivalent here: native/udpstream/udpstream.cpp implements sequencing,
retransmission, flow-control windows, and frame boundaries; this module
binds it with ctypes and adapts the blocking C API onto asyncio via worker
threads. Addresses use the `udp://host:port` scheme; everything above the
Transport seam (Noise encryption, protocol, roles) is transport-agnostic
and runs unchanged over it.

The shared library auto-builds on first use when a toolchain is present
(`make -C native`); environments without one fall back to TCP.
"""

from __future__ import annotations

import asyncio
import ctypes
import os
import subprocess
from typing import Optional

from symmetry_tpu_torch.transport.base import (
    Connection,
    ConnectionHandler,
    Listener,
    Transport,
)

_REPO_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
_LIB_PATH = os.path.join(_REPO_ROOT, "native", "build", "libudpstream.so")

_MAX_FRAME = 8 * 1024 * 1024


class UdpUnavailable(RuntimeError):
    pass


_lib: Optional[ctypes.CDLL] = None


def load_library() -> ctypes.CDLL:
    """Load (building if needed) the udpstream shared library."""
    global _lib
    if _lib is not None:
        return _lib
    if not os.path.exists(_LIB_PATH):
        native_dir = os.path.join(_REPO_ROOT, "native")
        try:
            subprocess.run(["make", "-C", native_dir], check=True,
                           capture_output=True, timeout=120)
        except (OSError, subprocess.SubprocessError) as exc:
            raise UdpUnavailable(
                f"libudpstream.so missing and build failed: {exc}") from exc
    lib = ctypes.CDLL(_LIB_PATH)
    lib.us_create.restype = ctypes.c_void_p
    lib.us_create.argtypes = [ctypes.c_char_p, ctypes.c_int]
    lib.us_port.restype = ctypes.c_int
    lib.us_port.argtypes = [ctypes.c_void_p]
    lib.us_dial.restype = ctypes.c_uint64
    lib.us_dial.argtypes = [ctypes.c_void_p, ctypes.c_char_p, ctypes.c_int,
                            ctypes.c_int]
    lib.us_accept.restype = ctypes.c_uint64
    lib.us_accept.argtypes = [ctypes.c_void_p, ctypes.c_int]
    lib.us_send.restype = ctypes.c_int
    lib.us_send.argtypes = [ctypes.c_void_p, ctypes.c_uint64,
                            ctypes.c_char_p, ctypes.c_int]
    lib.us_recv.restype = ctypes.c_int
    lib.us_recv.argtypes = [ctypes.c_void_p, ctypes.c_uint64,
                            ctypes.c_char_p, ctypes.c_int, ctypes.c_int]
    lib.us_close.argtypes = [ctypes.c_void_p, ctypes.c_uint64]
    lib.us_destroy.argtypes = [ctypes.c_void_p]
    lib.us_send_raw.restype = ctypes.c_int
    lib.us_send_raw.argtypes = [ctypes.c_void_p, ctypes.c_char_p,
                                ctypes.c_int, ctypes.c_char_p, ctypes.c_int]
    lib.us_recv_raw.restype = ctypes.c_int
    lib.us_recv_raw.argtypes = [ctypes.c_void_p, ctypes.c_char_p,
                                ctypes.c_int, ctypes.c_char_p,
                                ctypes.POINTER(ctypes.c_int), ctypes.c_int]
    _lib = lib
    return lib


class RawChannel:
    """Connectionless datagrams over a udpstream ctx's socket (F_RAW).

    The NAT-punch side channel: packets leave from the SAME (addr, port)
    the stream protocol uses, so a raw datagram opens exactly the NAT
    mapping a later us_dial / inbound SYN will traverse."""

    def __init__(self, ctx: int) -> None:
        self._lib = load_library()
        self._ctx = ctx

    def send(self, host: str, port: int, payload: bytes) -> bool:
        return bool(self._lib.us_send_raw(
            self._ctx, host.encode(), port, payload, len(payload)))

    async def recv(self, timeout_s: float
                   ) -> tuple[bytes, str, int] | None:
        """One raw datagram as (payload, host, port), or None on timeout."""
        buf = ctypes.create_string_buffer(2048)
        ip = ctypes.create_string_buffer(16)
        port = ctypes.c_int(0)
        n = await asyncio.to_thread(
            self._lib.us_recv_raw, self._ctx, buf, len(buf), ip,
            ctypes.byref(port), int(timeout_s * 1000))
        if n < 0:
            return None
        return buf.raw[:n], ip.value.decode(), port.value


def _parse(address: str) -> tuple[str, int]:
    addr = address.removeprefix("udp://")
    host, sep, port = addr.rpartition(":")
    if not sep or not port.isdigit():
        raise ValueError(f"bad udp address {address!r}: expected udp://host:port")
    return host or "127.0.0.1", int(port)


class UdpConnection(Connection):
    def __init__(self, ctx: int, key: int, remote: str) -> None:
        self._lib = load_library()
        self._ctx = ctx
        self._key = key
        self._remote = remote
        self._closed = False
        self._buf = ctypes.create_string_buffer(_MAX_FRAME)

    async def send(self, frame: bytes) -> None:
        if self._closed:
            raise ConnectionError("connection closed")
        rc = await asyncio.to_thread(
            self._lib.us_send, self._ctx, self._key, frame, len(frame))
        if rc != 0:
            self._closed = True
            raise ConnectionError("udp stream closed")

    async def recv(self) -> bytes | None:
        while not self._closed:
            n = await asyncio.to_thread(
                self._lib.us_recv, self._ctx, self._key, self._buf,
                _MAX_FRAME, 500)
            if n > 0:
                return self._buf.raw[:n]
            if n == 0:
                continue  # timeout tick; re-check closed
            if n == -2:
                raise ConnectionError("frame exceeds maximum size")
            self._closed = True
            return None
        return None

    async def close(self) -> None:
        if not self._closed:
            self._closed = True
            self._lib.us_close(self._ctx, self._key)

    @property
    def closed(self) -> bool:
        return self._closed

    @property
    def remote_address(self) -> str:
        return self._remote


class UdpListener(Listener):
    def __init__(self, ctx: int, host: str, handler: ConnectionHandler) -> None:
        self._lib = load_library()
        self._ctx = ctx
        self._host = host
        self._handler = handler
        self._closing = False
        self._task = asyncio.get_running_loop().create_task(self._accept_loop())

    @property
    def address(self) -> str:
        return f"udp://{self._host}:{self._lib.us_port(self._ctx)}"

    def raw_channel(self) -> RawChannel:
        """NAT-punch side channel on the LISTENER socket: raw datagrams
        from the same (addr, port) inbound streams arrive on, which is the
        port whose reflexive mapping the rendezvous must learn."""
        return RawChannel(self._ctx)

    async def _accept_loop(self) -> None:
        while not self._closing:
            key = await asyncio.to_thread(self._lib.us_accept, self._ctx, 500)
            if not key:
                continue
            conn = UdpConnection(self._ctx, key, "udp://?")
            task = asyncio.get_running_loop().create_task(self._handler(conn))
            task.add_done_callback(lambda t: t.exception())

    async def close(self) -> None:
        self._closing = True
        self._task.cancel()
        try:
            await self._task
        except (asyncio.CancelledError, Exception):  # noqa: BLE001
            pass
        await asyncio.to_thread(self._lib.us_destroy, self._ctx)


class UdpTransport(Transport):
    """Transport over the native udpstream library (scheme `udp://`)."""

    scheme = "udp"

    def __init__(self) -> None:
        self._lib = load_library()
        self._dial_ctx: int | None = None

    async def listen(self, address: str, handler: ConnectionHandler) -> Listener:
        host, port = _parse(address)
        ctx = self._lib.us_create(host.encode(), port)
        if not ctx:
            raise OSError(f"cannot bind udp socket at {address}")
        return UdpListener(ctx, host, handler)

    def _ensure_dial_ctx(self) -> int:
        if self._dial_ctx is None:
            self._dial_ctx = self._lib.us_create(b"0.0.0.0", 0)
            if not self._dial_ctx:
                raise OSError("cannot create udp dial socket")
        return self._dial_ctx

    def dial_raw_channel(self) -> RawChannel:
        """Raw datagrams from the DIAL socket: a punch sent here opens the
        pinhole that this transport's subsequent dial() will traverse
        (same ctx, same port — network/natpunch.py)."""
        return RawChannel(self._ensure_dial_ctx())

    async def dial(self, address: str) -> Connection:
        host, port = _parse(address)
        ctx = self._ensure_dial_ctx()
        key = await asyncio.to_thread(
            self._lib.us_dial, ctx, host.encode(), port, 5000)
        if not key:
            raise ConnectionError(f"udp dial to {address} failed")
        return UdpConnection(ctx, key, address)
