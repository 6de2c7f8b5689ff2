"""Disaggregated prefill/decode: the KV-handoff frames.

Port of symmetry_tpu/engine/disagg/, frames only: the prefill tier cuts
each finished prompt's KV into a versioned binary frame (the host's
`handoff` op) and the decode tier adopts it through its prefix store
(`adopt` op, engine.adopt_prefix). The broker, pool, autoscaler and the
cross-machine link run inside the provider backend and are not ported.
"""

from symmetry_tpu_torch.engine.disagg.frames import (
    BFloat16Array,
    FrameError,
    KVHandoff,
    decode_frame,
    decode_kv_handoff,
    encode_frame,
    encode_kv_handoff,
    wire_dtype,
)

__all__ = [
    "BFloat16Array",
    "FrameError",
    "KVHandoff",
    "decode_frame",
    "decode_kv_handoff",
    "encode_frame",
    "encode_kv_handoff",
    "wire_dtype",
]
