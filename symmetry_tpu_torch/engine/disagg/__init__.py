"""Disaggregated prefill/decode: KV-handoff frames + the tier broker.

The production-serving split (DistServe OSDI'24, Splitwise ISCA'24, see
PAPERS.md): admissions/chunked prefill on one engine host, generation on
another, with each finished prompt's KV crossing the boundary as a
versioned binary frame the decode tier adopts through its prefix store.
`tpu.role` selects a host's tier; `tpu.role: disagg` makes the
tpu_native backend run the pair under one supervisor.

Cross-machine: `tpu.disagg.peer` switches the backend to NETWORK mode —
the decode tier stays local and the prefill tier runs on another
machine as an engine/disagg/node.py PrefillNode, the two joined by the
chunked, credit-flow-controlled, acked handoff link in
engine/disagg/net.py over the transport/ stack (MemoryTransport in
tests, TCP in production, optional Noise encryption).
"""

from symmetry_tpu_torch.engine.disagg.autoscale import (
    AutoscaleConfig,
    PoolAutoscaler,
)
from symmetry_tpu_torch.engine.disagg.broker import (
    DEFAULT_DECODE_PREFIX_MB,
    HandoffBroker,
    derive_role_config,
)
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
from symmetry_tpu_torch.engine.disagg.net import (
    DecodeLink,
    LinkConfig,
    LinkError,
)
from symmetry_tpu_torch.engine.disagg.pool import (
    MemberState,
    PoolConfig,
    PoolRouter,
)

__all__ = [
    "AutoscaleConfig",
    "BFloat16Array",
    "DEFAULT_DECODE_PREFIX_MB",
    "DecodeLink",
    "PoolAutoscaler",
    "FrameError",
    "HandoffBroker",
    "KVHandoff",
    "LinkConfig",
    "LinkError",
    "MemberState",
    "PoolConfig",
    "PoolRouter",
    "decode_frame",
    "decode_kv_handoff",
    "derive_role_config",
    "encode_frame",
    "encode_kv_handoff",
    "wire_dtype",
]
