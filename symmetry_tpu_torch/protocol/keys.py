"""Wire-protocol message keys.

Superset of the reference's `serverMessageKeys` vocabulary
(reference: src/constants.ts:3-20), which is the de-facto protocol spec between
server, provider, and client. The reference's misspelled `conectionSize` is kept
as an accepted alias for interop.

New keys (marked TPU) extend the protocol for the native engine: structured
token streaming, usage metrics, and graceful drain.
"""

from __future__ import annotations


class MessageKey:
    # --- reference vocabulary (src/constants.ts:3-20) ---
    CHALLENGE = "challenge"
    CONNECTION_SIZE = "connectionSize"
    CONNECTION_SIZE_ALIAS = "conectionSize"  # sic — reference spelling, accepted on ingress
    HEARTBEAT = "heartbeat"
    INFERENCE = "inference"
    INFERENCE_ENDED = "inferenceEnded"
    JOIN = "join"
    JOIN_ACK = "joinAck"
    LEAVE = "leave"
    NEW_CONVERSATION = "newConversation"
    PING = "ping"
    PONG = "pong"
    PROVIDER_DETAILS = "providerDetails"
    REPORT_COMPLETION = "reportCompletion"
    REQUEST_PROVIDER = "requestProvider"
    SESSION_VALID = "sessionValid"
    VERIFY_SESSION = "verifySession"

    # --- TPU-native extensions ---
    CHALLENGE_RESPONSE = "challengeResponse"  # signed challenge reply (both directions)
    TOKEN_CHUNK = "tokenChunk"                # structured streamed tokens (engine-native)
    INFERENCE_ERROR = "inferenceError"        # structured mid-stream failure
    INFERENCE_CANCEL = "inferenceCancel"      # client aborts one in-flight
                                              # request by its requestId
    DRAIN = "drain"                           # graceful shutdown: stop accepting, finish in-flight
    METRICS = "metrics"                       # provider → server load metrics (tok/s, queue
                                              # depth); client ⇄ provider stats probe — the
                                              # reply carries the stats snapshot plus a
                                              # "metrics" block of tier-labeled registry
                                              # snapshots (utils/metrics.py), so symtop and
                                              # the swarm path scrape without an open port
    PROVIDER_LIST = "providerList"            # server → client available models
    TRACE = "trace"                           # client ⇄ provider: merged span-ring
                                              # snapshot (client, provider, host,
                                              # scheduler components) for the
                                              # Perfetto timeline export
    PROFILE = "profileCapture"                # client ⇄ provider: trigger one
                                              # bounded on-device jax.profiler
                                              # capture (HostOp.PROFILE under-
                                              # neath); the reply carries the
                                              # trace-artifact path or an error

    # --- relay (NAT fallback: server splices client↔provider, payload
    #     stays end-to-end Noise-encrypted — the reference gets this leg
    #     from hyperdht relaying; network/relay.py) ---
    RELAY_CONNECT = "relayConnect"            # client → server {providerKey}
    RELAY_OPEN = "relayOpen"                  # server → provider {relayId}
    RELAY_ACCEPT = "relayAccept"              # provider → server {relayId}
    RELAY_READY = "relayReady"                # server → both ends
    RELAY_DATA = "relayData"                  # spliced opaque frames
    RELAY_CLOSE = "relayClose"                # either end / server teardown


class HostOp:
    """Engine-host pipe ops — the `{"op": ...}` JSON-lines protocol
    between the provider backend and its engine-host subprocess(es)
    (spec: engine/host.py docstring; disagg forwarding:
    engine/disagg/broker.py).

    One registry on purpose: producers and consumers both import these
    constants, and the symlint wire-contract checker (tools/symlint.py)
    fails CI on any raw op literal or any op produced without a
    consumer — a renamed op used to mean a silently-dropped frame and
    a hung stream, not an error."""

    # --- commands: provider/broker → host stdin ---
    SUBMIT = "submit"       # new request (messages, sampling, deadline…)
    ADOPT = "adopt"         # decode role: adopt a handed-off KV frame
    CANCEL = "cancel"       # abort one in-flight request by id
    CLOCK = "clock"         # clock-offset handshake probe (echoed back)
    TRACE = "trace"         # span-ring snapshot request (echoed back)
    STATS = "stats"         # scheduler/emit counters probe (echoed
                            # back). The reply doubles as the pool
                            # gossip carrier: a host with a live radix
                            # cache attaches a "prefix_summary" rider
                            # (bounded block digests + depth histogram,
                            # engine/prefix_cache.py summary()) that
                            # the pool router harvests off its
                            # heartbeat probes for cache-affine
                            # placement — no new op, no extra wire
                            # round-trip. Symmetrically, SUBMIT carries
                            # an optional "ledger" rider ({member,
                            # epoch}) telling the prefill host which
                            # decode member's shipped-block ledger the
                            # handoff should be keyed against. The same
                            # reply is the autoscaler's sensor feed:
                            # "queue_depth" and the symprof "devprof"
                            # block (device_s_total) are differenced
                            # per heartbeat into the per-tier load and
                            # measured-M:N-ratio inputs of
                            # engine/disagg/autoscale.py.
    METRICS = "metrics"     # metrics-registry snapshot probe (echoed
                            # back with the host process's registry
                            # families + its tier role; the provider
                            # merges them tier-labeled into its own
                            # exposition and the MessageKey.METRICS
                            # reply — the swarm path needs no open port)
    PROFILE = "profile"     # on-demand jax.profiler capture: the host
                            # runs a bounded device trace off the
                            # serve loop and echoes the artifact path
                            # (or an error) back — triggered by the
                            # provider wire op, SIGUSR1, or the SLO
                            # burn-rate breach hook (utils/devprof.py)
    SHUTDOWN = "shutdown"   # graceful drain + exit

    # --- frames: host stdout → provider ---
    READY = "ready"         # warmup done, model/slots/geometry attached
    EVENT = "event"         # one token event (legacy single-event frame)
    EVENTS = "events"       # batched per-block token events (hot path)
    HANDOFF = "handoff"     # prefill role: serialized KV prefix frame


HOST_OPS = frozenset(
    v for k, v in vars(HostOp).items()
    if not k.startswith("_") and isinstance(v, str)
)


class LinkOp:
    """Cross-machine handoff-link ops — the `{"op": ...}` envelope headers
    of the disagg network transport (engine/disagg/net.py) between a
    decode-tier node (the tpu_native provider) and a prefill-tier node
    (engine/disagg/node.py), carried over the transport/ stack.

    Same registry discipline as HostOp: producers and consumers both
    import these constants and the symlint wire-contract checker scans
    the link-protocol group (LINK_GROUP in analysis/wire_contract.py),
    so a renamed link op fails CI instead of silently stranding a
    handoff mid-wire. Where a link op FORWARDS a host op (submit,
    cancel, stats, trace), the value is deliberately the same string —
    the node can splice the payload straight onto the host pipe."""

    # --- control (both directions) ---
    HELLO = "hello"         # link handshake: version, role, credit
                            # window, node identity ("node") — the pool
                            # router's join/announce signal
    CLOCK = "clock"         # clock-offset probe (echoed with "t"), same
                            # NTP-midpoint protocol as the host pipe
    PING = "ping"           # link keepalive probe (pool heartbeat; the
                            # decode side drops a silent link and lets
                            # the reconnect loop own recovery)
    PONG = "pong"           # keepalive reply (echoes the ping's "t")

    # --- decode node → prefill node ---
    SUBMIT = "submit"       # forwarded host submit op (payload = JSON line)
    CANCEL = "cancel"       # forwarded host cancel op
    STATS = "stats"         # stats probe: node replies host stats + link stats
    TRACE = "trace"         # trace probe: node replies host span rings
    CREDIT = "credit"       # flow control: return n consumed chunk bytes
    ACK = "ack"             # handoff transfer fully reassembled + forwarded
    NAK = "nak"             # transfer failed integrity — sender retransmits

    # --- prefill node → decode node ---
    BEGIN = "begin"         # handoff transfer start: id, xfer, len, meta
    CHUNK = "chunk"         # one payload chunk: id, xfer, seq + raw bytes
    END = "end"             # transfer complete: id, xfer, crc
    FAIL = "fail"           # handoff abandoned (retries exhausted / host
                            # death) — the decode node sheds the request
    EVENT = "event"         # prefill-tier terminal event (tokenization /
                            # admission error, deadline shed) forwarded
    DRAIN = "drain"         # node announces deliberate drain: no new
                            # placements; in-flight work finishes
    LEAVE = "leave"         # node announces departure (drain complete /
                            # shutdown) — membership churn, not a fault


LINK_OPS = frozenset(
    v for k, v in vars(LinkOp).items()
    if not k.startswith("_") and isinstance(v, str)
)


SERVER_MESSAGE_KEYS = frozenset(
    v for k, v in vars(MessageKey).items() if not k.startswith("_")
)


def normalize_key(key: str) -> str:
    """Map reference-compat aliases to canonical keys."""
    if key == MessageKey.CONNECTION_SIZE_ALIAS:
        return MessageKey.CONNECTION_SIZE
    return key
