from symmetry_tpu_torch.protocol.keys import MessageKey, SERVER_MESSAGE_KEYS

__all__ = [
    "MessageKey",
    "SERVER_MESSAGE_KEYS",
]
