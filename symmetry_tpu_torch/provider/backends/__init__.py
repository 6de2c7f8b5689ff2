from symmetry_tpu_torch.provider.backends.base import InferenceBackend, StreamChunk, get_backend
from symmetry_tpu_torch.provider.backends.echo import EchoBackend

__all__ = ["InferenceBackend", "StreamChunk", "get_backend", "EchoBackend"]
