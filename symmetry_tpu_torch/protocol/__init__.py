from symmetry_tpu_torch.protocol.keys import MessageKey, SERVER_MESSAGE_KEYS
from symmetry_tpu_torch.protocol.messages import Message, create_message, parse_message
from symmetry_tpu_torch.protocol.framing import FrameReader, encode_frame, MAX_FRAME_SIZE

__all__ = [
    "MessageKey",
    "SERVER_MESSAGE_KEYS",
    "Message",
    "create_message",
    "parse_message",
    "FrameReader",
    "encode_frame",
    "MAX_FRAME_SIZE",
]
