"""Protocol layer: framing, envelopes, keys."""

import pytest

from symmetry_tpu_torch.protocol import (
    FrameReader,
    MAX_FRAME_SIZE,
    MessageKey,
    create_message,
    encode_frame,
    parse_message,
)
from symmetry_tpu_torch.protocol.framing import FrameError
from symmetry_tpu_torch.protocol.keys import SERVER_MESSAGE_KEYS, normalize_key


def test_frame_roundtrip():
    reader = FrameReader()
    payloads = [b"a", b"", b"x" * 100_000, bytes(range(256))]
    stream = b"".join(encode_frame(p) for p in payloads)
    out = []
    # Feed in adversarially small chunks to prove incremental parsing.
    for i in range(0, len(stream), 7):
        out.extend(reader.feed(stream[i : i + 7]))
    assert out == payloads


def test_frame_boundary_preserved_across_coalesced_writes():
    # The failure mode the reference has (unframed JSON, one write != one read):
    # two messages coalesced into one chunk must still parse as two frames.
    reader = FrameReader()
    chunk = encode_frame(b'{"key":"ping"}') + encode_frame(b'{"key":"pong"}')
    assert list(reader.feed(chunk)) == [b'{"key":"ping"}', b'{"key":"pong"}']


def test_oversized_frame_rejected():
    reader = FrameReader()
    import struct

    with pytest.raises(FrameError):
        list(reader.feed(struct.pack(">I", MAX_FRAME_SIZE + 1)))


def test_message_roundtrip():
    raw = create_message(MessageKey.INFERENCE, {"messages": [{"role": "user", "content": "hi"}]})
    msg = parse_message(raw)
    assert msg is not None
    assert msg.key == MessageKey.INFERENCE
    assert msg.data["messages"][0]["content"] == "hi"


def test_message_without_data():
    msg = parse_message(create_message(MessageKey.PING))
    assert msg is not None and msg.key == MessageKey.PING and msg.data is None


def test_malformed_messages_return_none():
    assert parse_message(b"not json") is None
    assert parse_message(b"[1,2,3]") is None
    assert parse_message(b'{"nokey":1}') is None
    assert parse_message(b'{"key":42}') is None
    assert parse_message(None) is None


def test_reference_vocabulary_present():
    # The de-facto protocol spec from reference src/constants.ts:3-20.
    for key in [
        "challenge", "heartbeat", "inference", "inferenceEnded", "join", "joinAck",
        "leave", "newConversation", "ping", "pong", "providerDetails",
        "reportCompletion", "requestProvider", "sessionValid", "verifySession",
    ]:
        assert key in SERVER_MESSAGE_KEYS


def test_reference_misspelling_normalized():
    # Reference spells it `conectionSize` (src/constants.ts:5); we accept it.
    assert normalize_key("conectionSize") == MessageKey.CONNECTION_SIZE
    msg = parse_message(create_message("conectionSize", 3))
    assert msg.key == MessageKey.CONNECTION_SIZE
