"""Length-prefixed frame codec.

The reference writes raw JSON strings to the peer stream and hopes message
boundaries survive (src/provider.ts:97-108 writes, 110-115 parse of whole
`data` events). Here every payload travels as a frame:

    [4-byte big-endian length N][N bytes payload]

A frame payload is either plaintext JSON (pre-handshake) or ciphertext
(post-handshake, see symmetry_tpu.identity.noise). The codec is sans-IO:
`FrameReader.feed()` accepts arbitrary byte chunks and yields complete frames,
so it works over asyncio, tests, or a C++ transport equally.

A native C++ implementation of the same codec lives in native/; this module is
the always-available pure-Python path.
"""

from __future__ import annotations

import struct
from typing import Iterator

MAX_FRAME_SIZE = 32 * 1024 * 1024  # 32 MiB — bounds memory per peer
_HEADER = struct.Struct(">I")


class FrameError(ValueError):
    """Raised when a peer sends a malformed or oversized frame."""


def encode_frame(payload: bytes) -> bytes:
    if len(payload) > MAX_FRAME_SIZE:
        raise FrameError(f"frame too large: {len(payload)}")
    return _HEADER.pack(len(payload)) + payload


class FrameReader:
    """Incremental frame parser. Feed bytes, iterate complete frames."""

    def __init__(self) -> None:
        self._buf = bytearray()
        self._need: int | None = None  # payload length of the frame in progress

    def feed(self, chunk: bytes) -> Iterator[bytes]:
        self._buf.extend(chunk)
        while True:
            if self._need is None:
                if len(self._buf) < _HEADER.size:
                    return
                (need,) = _HEADER.unpack_from(self._buf)
                if need > MAX_FRAME_SIZE:
                    # Don't poison state: a caller that keeps feeding after the
                    # error must not start buffering toward the bogus length.
                    raise FrameError(f"frame too large: {need}")
                self._need = need
                del self._buf[: _HEADER.size]
            if len(self._buf) < self._need:
                return
            payload = bytes(self._buf[: self._need])
            del self._buf[: self._need]
            self._need = None
            yield payload


