"""Provider configuration: YAML file, validated, typed access.

Same `provider.yaml` surface as the reference's ConfigManager
(reference: src/config.ts:5-51, schema src/types.ts:4-21) — fields
`apiHostname/apiPath/apiPort/apiProtocol/apiProvider/modelName/name/path/
public/serverKey/dataCollectionEnabled/maxConnections/apiKey` and `-c` CLI
override — extended with a `tpu` section for the native engine (mesh shape,
dtype, KV budget, checkpoint path) per the BASELINE.json north star.

Differences from the reference, on purpose:
  - `api*` fields are required only for HTTP-proxy backends; the flagship
    `tpu_native` backend needs none of them.
  - `apiKey` is never forwarded to the network (the reference sends the whole
    config, apiKey included, to the server at join — src/provider.ts:103-108).
"""

from __future__ import annotations

import os
from dataclasses import dataclass, field
from typing import Any

# Reference provider registry (src/constants.ts:22-29) + the TPU-native backends.
PROXY_PROVIDERS = ("litellm", "llamacpp", "lmstudio", "ollama", "oobabooga", "openwebui")
NATIVE_PROVIDERS = ("tpu_native", "echo")
API_PROVIDERS = PROXY_PROVIDERS + NATIVE_PROVIDERS

_REQUIRED_ALWAYS = ("apiProvider", "modelName", "name", "public", "serverKey")
# Reference's required list (src/config.ts:20-30) minus what tpu_native doesn't need.
_REQUIRED_PROXY = ("apiHostname", "apiPath", "apiPort", "apiProtocol")


class ConfigError(ValueError):
    pass


@dataclass
class TpuConfig:
    """Engine settings for the `tpu_native` backend."""

    mesh: dict[str, int] = field(default_factory=lambda: {"data": 1, "model": 1})
    dtype: str = "bfloat16"            # parameter/compute dtype
    quantization: str | None = None    # None | "int8" (weights)
    kv_quantization: str | None = None  # None | "int8" (KV cache)
    # W8A16 fused-dequant matmul (ops/qmm.py w8a16_matmul): int8 weights
    # pre-packed into the kernel's tile layout at load and dequantized in
    # VMEM inside the double-buffered DMA/matmul pipeline, instead of
    # XLA's full bf16 weight materialization per decode step (the
    # rounds-3/4 convert wall). Requires quantization: int8; composes
    # with tpu.mesh — tiles pack against the PER-SHARD dims after the
    # sharding decision, column-/row-parallel leaves run a shard_map'd
    # per-shard kernel, and a leaf whose shard loses tileability keeps
    # the mixed dot (counted in sym_qmm_fallback_total, never silent).
    # Off by default pending the on-chip A/B (BASELINE.md decode-floor
    # section; bench.py --fused-dequant / tools/probe_w8a16.py).
    fused_dequant: bool = False
    max_batch_size: int = 8            # decode slots (continuous batching)
    max_seq_len: int = 2048            # KV capacity per slot
    prefill_buckets: tuple[int, ...] = (128, 512, 2048)
    prefill_chunk: int | None = 256    # chunked-prefill step; None disables
    # Coalesced-prefill width cap per bucket: batch × bucket ≤ budget
    # (engine.prefill_batches_for). None → engine default (2048 tokens).
    prefill_token_budget: int | None = None
    # Shared-prefix KV cache HBM budget in MiB (engine/prefix_cache.py):
    # prompts sharing a system-prompt/few-shot preamble skip prefill for
    # the cached portion — the scheduler partitions admissions into
    # hit/miss dispatch units and the hit path copies the cached prefix
    # KV into the slot lane, prefilling only the uncached suffix. None/0
    # disables the cache entirely (no lookups, no extra warmup compiles).
    prefix_cache_mb: float | None = None
    # Tokens per KV block in the radix prefix cache's paged pool. Shared
    # prefixes match at THIS granularity (any whole-block prefix hits —
    # multi-turn histories of arbitrary length, not just bucket-aligned
    # preambles); smaller blocks share more but cost more index entries
    # and a longer re-prefilled tail on handoff. Must divide every
    # prefill bucket (enforced only when the cache is enabled).
    prefix_block_tokens: int = 16
    # Radix-cache summary gossip (pool routing): how many hot-path
    # block digests each engine's cache summary carries on its stats
    # probe — the PoolRouter's cache-affinity signal. 0 disables the
    # rider (members gossip nothing; placement is load-only). ~32 B of
    # wire per digest per heartbeat per member.
    prefix_gossip_blocks: int = 64
    # Minimum seconds between summary recomputes on the engine host —
    # per-member heartbeat probes inside this window share one cached
    # walk. Staleness decay in the router is governed by the POOL
    # heartbeat_s, not this knob.
    prefix_gossip_s: float = 2.0
    # Cache-affinity weight in pool placement: predicted-hit blocks
    # (from gossiped summaries, staleness-decayed) count this much
    # against load (queue slots) when scoring members — at 1.0 one
    # fresh predicted hit block outbids one queued request. 0 restores
    # pure least-loaded placement.
    pool_affinity_weight: float = 1.0
    # Prefill-role only: skip handoff-frame payloads for blocks this
    # host already shipped to the destination member (the receiver
    # adopts them by reference from its radix tree). The ledger is
    # per-destination and epoch-invalidated: pool routing stamps every
    # submit with the planned decode member and its ledger epoch
    # (bumped on member loss), so a respawned member's empty cache
    # drops its ledger instead of silently degrading every warm
    # handoff to a full re-prefill. Correctness never depends on it —
    # the receiver adopts the longest covered prefix either way.
    handoff_ledger: bool = True
    # Speculative decoding (engine/spec/): n-gram prompt-lookup drafting
    # with batched block verification. None/False disables it entirely —
    # the decode path and warmup compile set are then byte-identical to a
    # build without the feature. True enables defaults; an int sets
    # k_draft (draft tokens per slot per verify dispatch); a mapping may
    # set {k_draft, ngram_max, ngram_min, max_index_tokens}. Helps
    # workloads whose output
    # repeats spans of their own context (code edits, RAG quoting,
    # extractive answers); hurts incompressible chat — watch the
    # acceptance_rate counter in stats. Greedy output is token-identical
    # with the knob on or off; sampled lanes stay unbiased via rejection
    # sampling. Per-request opt-out: "speculative": false on the request.
    speculative: Any = None
    # Decode steps per device dispatch. 16 measured throughput-equal to
    # 64 at the llama3-8b/128-slot point (double-buffered dispatch hides
    # the round-trips) with ~2x lower TTFT and inter-chunk latency.
    decode_block: int = 16
    # Scheduler pipeline depth: decode blocks kept dispatched-but-unsynced
    # between loop iterations. At >= 2 the scheduler also moves every
    # non-dispatch per-block cost (detokenize, event encode, pipe emit,
    # bookkeeping) onto a bounded-queue emit worker, so the dispatch
    # thread's iteration approaches the bare dispatch cost (the
    # dispatch-gap fix, ROADMAP item 2). 1 = the pre-pipeline
    # double-buffer loop with inline emit, the A/B baseline. Token
    # streams are identical across depths (greedy and seeded); a deeper
    # pipeline only trades per-token wire latency (up to depth-1 extra
    # blocks of buffering) for steady throughput. Prefill-tier hosts in
    # disagg mode force 1 — they never decode.
    pipeline_depth: int = 2
    # Requests allowed to QUEUE beyond the decode slots before the
    # provider sheds new inference with a structured busy error (clients
    # fail over; the router steers by reported queue depth). None → one
    # full extra wave (= max_batch_size): an admitted request then waits
    # at most ~one slot rotation, bounding its TTFT near the per-request
    # service time instead of growing with the backlog. 0 disables
    # queueing (shed the moment every slot is busy).
    max_queue: int | None = None
    # symprof device-time attribution (utils/devprof.py): every Nth
    # engine dispatch of each kind (prefill/chunk/decode_block/verify/
    # adopt/seed_gather/scatter) is completion-probed — timestamped
    # block_until_ready — yielding per-kind DEVICE-duration histograms
    # and the dispatch-gap series (host idle between device blocks, the
    # rounds-3/4 steady-wire suspect) in stats/metrics/the Perfetto
    # device track. 0 (default) disables: one branch per dispatch,
    # CI-asserted like the metrics registry. Sampling serializes 1
    # dispatch in N, so keep N large enough that tok/s stays within 1%
    # (BASELINE.md Round 15 pre-registers the A/B).
    profile_sample: int = 0
    # Request-scoped tracing (utils/trace.py): bounded span/counter rings
    # in the scheduler and host, read through the host-pipe `trace` op and
    # exported as a Perfetto timeline (provider `trace` op, bench.py
    # --trace-out). Cheap enough to leave on (a few ring appends per
    # decode block); False empties the rings entirely — the bench A/B
    # knob for proving the overhead stays under 1%.
    tracing: bool = True
    # symledger per-request cost attribution (engine/ledger.py): the
    # scheduler apportions every dispatch's measured wall to the
    # requests it served (prefill/chunk exact, decode/verify blocks by
    # active-slot occupancy), each finish event carries a `costs` block
    # (device_s{phase}/queue_s/emit_s/wasted_s{reason}/saved_s), the
    # host STATS reply ships a bounded ring + aggregates, and the
    # provider folds per-request SLO attainment into windowed goodput
    # (sym_goodput_tokens_per_device_second) and feeds the autoscaler's
    # SLO-attaining numerator. False disables: one guarded branch per
    # dispatch (same overhead contract as metrics.enabled and
    # tpu.faults; BASELINE.md Round 20 pre-registers the ≤1% A/B).
    ledger: bool = True
    # TTFT-bounded admission: shed a new request when the provider's
    # ESTIMATED first-token wait (requests awaiting their first token ÷
    # recent first-token rate) exceeds this many seconds. Catches the
    # overload mode the in-flight bound can't: during a sustained-arrival
    # ramp the limiter is prefill dispatch rate, so the scheduler inbox
    # can hold seconds of wait while decode slots are still free. None
    # (default) disables the bound — a pure thundering-herd burst from
    # idle is admitted in full either way (no recent rate signal → no
    # shedding on ignorance).
    max_ttft_s: float | None = None
    # "process" (default, production): the engine runs in a host
    # subprocess behind a pipe — its GIL-held device syncs would
    # otherwise starve the provider's event loop and every stream's
    # latency with it (engine/host.py). "inproc": same-process engine
    # thread (tests, debugging).
    engine_isolation: str = "process"
    # Disaggregated prefill/decode (engine/disagg/). "unified" (default):
    # today's behavior, one engine does both phases. "disagg": the
    # backend runs a PREFILL host (admissions + chunked prefill only;
    # serializes each finished prompt's KV into a versioned handoff
    # frame) and a DECODE host (adopts frames through its prefix store —
    # auto-enabled with a default budget — and generates), with the
    # handoff broker routing submits to the prefill tier and piping
    # handoff → adopt between them; the pair is supervised as ONE unit
    # (either host dying triggers the restarting-shed + respawn path).
    # "prefill"/"decode" are the per-tier host roles the broker assigns —
    # set them directly only when driving engine/host.py by hand.
    # Requires engine_isolation "process" and a single-device engine.
    # Greedy output is token-identical disagg vs unified (test-enforced).
    role: str = "unified"
    # Per-tier overrides for role: disagg — {"prefill": {...}, "decode":
    # {...}}, each a mapping merged into that tier's tpu section; the
    # special key "faults" inside a tier lands as that HOST's top-level
    # faults mapping (chaos-test one tier of the pair).
    #
    # CROSS-MACHINE keys (engine/disagg/net.py — the handoff link):
    #   peer: "tcp://host:port"   decode/provider side: dial the prefill
    #                             node there instead of spawning a local
    #                             prefill host (NETWORK mode)
    #   listen: "tcp://0.0.0.0:port"  prefill-node side (node.py): bind
    #   inline: bool = false      backend self-hosts the PrefillNode
    #                             in-process and dials it at `peer` —
    #                             the full wire path in one provider
    #                             (bench --disagg-transport, CI smoke)
    #   chunk_kb: int = 1024      handoff chunk size on the link
    #   credit_mb: float = 64     receiver credit window (bounds
    #                             in-flight bytes; exhaustion throttles
    #                             prefill admissions via the sink)
    #   ack_timeout_s: float = 30 unacked transfer → retransmit
    #   max_retries: int = 2      then the request sheds retryable
    #   reconnect_base_s/reconnect_max_s   link redial backoff
    #   encrypt: bool = false     Noise handshake on the link (needs the
    #                             `cryptography` dependency); optional
    #   secret: str               identity seed name; peer_key: hex —
    #                             pin the expected remote static key
    disagg: dict[str, Any] | None = None
    # SLO-goodput autoscaler for the elastic disagg pool
    # (engine/disagg/autoscale.py): a controller tick inside the pool
    # heartbeat turns SLO burn rates + queue gauges + symprof's measured
    # per-tier device cost into real membership ops (spawn / drain /
    # rebalance the M×N shape). None (default) → the pool shape stays
    # whatever `disagg.pool` declared. Keys (all optional):
    #   enabled: bool = true          master switch
    #   max_members: int = 4          per-tier ceiling (floor is 1×1)
    #   dwell_s: float = 30.0         min seconds between decisions
    #   churn_cooldown_s: float = 60  scaling pause after a churn respawn
    #   spawn_burn: float = 1.0       fast-window SLO burn → spawn
    #   spawn_queue: float = 2.0      avg per-member load → spawn
    #   drain_load: float = 0.25      avg load at/under which a tier idles
    #   drain_ticks: int = 3          consecutive idle ticks → drain
    #   min_busy_s: float = 0.05      device-busy floor for the measured
    #                                 M:N rebalance signal
    autoscale: dict[str, Any] | None = None
    # Engine-host supervision (process isolation only): a heartbeat
    # watchdog piggybacked on the host stats op detects crashes AND
    # wedges with a much tighter deadline than the 15 s provider health
    # loop, fails every in-flight stream with a retryable
    # {"restarting": true} shed, and auto-respawns the host (warm
    # compile cache makes a config-identical respawn cheap) with
    # exponential backoff; only after max_respawns CONSECUTIVE failed
    # respawns does the circuit breaker open and the provider deregister
    # (the pre-supervisor behavior). Keys (all optional):
    #   enabled: bool = true         supervision on/off
    #   heartbeat_s: float = 5.0     watchdog probe cadence
    #   wedge_timeout_s: float = 5.0 no stats reply within this → wedged
    #   backoff_base_s: float = 0.5  first-respawn delay (doubles per
    #                                consecutive failure)
    #   backoff_max_s: float = 15.0  backoff ceiling
    #   max_respawns: int = 3        consecutive failures → circuit open
    #   min_stable_s: float = 5.0    a life must survive this long to
    #                                reset the failure count (crash-LOOPs
    #                                trip the breaker, not flap forever)
    #   spawn_timeout_s: float = 600 respawn must reach ready within this
    #   stop_grace_s: float = 30     shutdown drain before SIGKILL
    supervisor: dict[str, Any] | None = None
    pipeline_microbatches: int = 1     # GPipe microbatches (mesh stage > 1)
    checkpoint_path: str | None = None  # HF safetensors dir; None → random init
    # Cache the finished (stacked/transposed/quantized) param tree beside
    # the checkpoint on first load; restarts skip the whole conversion
    # (engine/weights.py save_warm_cache). SURVEY §5.4 warm restart.
    warm_cache: bool = True
    # Persistent XLA compilation cache (utils/compile_cache.py): True →
    # ~/.cache/symmetry_tpu/xla, a string → that directory, False → off.
    # A config-identical engine restart then compiles ~nothing.
    compile_cache: Any = True
    tokenizer_path: str | None = None   # tokenizer.json; None → byte tokenizer
    # Informational: every supported family (llama 3.x, mistral, qwen2,
    # mixtral-MoE, gemma) shares the decoder in models/llama.py, selected
    # by ModelConfig flags; checkpoints self-describe via config.json.
    model_family: str = "llama"
    model_preset: str | None = None     # e.g. "llama3-8b", "tiny" (tests)
    # Multi-host provider (SURVEY §7 stage 6): one logical provider backed
    # by N JAX processes. Keys: coordinator ("host:port"), num_processes,
    # process_id, dcn_data (hosts on the data axis). Rank 0 fronts the
    # network; other ranks run `python -m symmetry_tpu.provider --worker`.
    multihost: dict[str, Any] | None = None

    @classmethod
    def from_dict(cls, raw: dict[str, Any]) -> "TpuConfig":
        kwargs = {}
        for f in cls.__dataclass_fields__:
            if f in raw:
                kwargs[f] = tuple(raw[f]) if f == "prefill_buckets" else raw[f]
        unknown = set(raw) - set(cls.__dataclass_fields__)
        if unknown:
            raise ConfigError(f"unknown tpu config keys: {sorted(unknown)}")
        return cls(**kwargs)


class ConfigManager:
    """Reads + validates a provider.yaml (reference: src/config.ts:5-51)."""

    def __init__(self, config_path: str | None = None,
                 config: dict[str, Any] | None = None) -> None:
        if config is not None:
            self._config = dict(config)
        else:
            if config_path is None:
                config_path = default_config_path()
            import yaml

            with open(os.path.expanduser(config_path), "r", encoding="utf-8") as fh:
                loaded = yaml.safe_load(fh)
            if not isinstance(loaded, dict):
                raise ConfigError(f"config at {config_path} is not a mapping")
            self._config = loaded
        self._tpu = TpuConfig.from_dict(self._config.get("tpu") or {})
        self.validate()

    def validate(self) -> None:
        missing = [k for k in _REQUIRED_ALWAYS if self._config.get(k) is None]
        provider = self._config.get("apiProvider")
        if provider in PROXY_PROVIDERS:
            missing += [k for k in _REQUIRED_PROXY if self._config.get(k) is None]
        if missing:
            raise ConfigError(f"missing required config: {sorted(missing)}")
        if provider not in API_PROVIDERS:
            raise ConfigError(
                f"unknown apiProvider {provider!r}; expected one of {API_PROVIDERS}"
            )
        if not isinstance(self._config["public"], bool):
            # Reference enforces the same (src/config.ts:40-44).
            raise ConfigError("config field 'public' must be a boolean")
        if "maxConnections" in self._config and (
            not isinstance(self._config["maxConnections"], int)
            or self._config["maxConnections"] < 1
        ):
            raise ConfigError("maxConnections must be a positive integer")

    def get(self, key: str, default: Any = None) -> Any:
        return self._config.get(key, default)

    def get_all(self) -> dict[str, Any]:
        return dict(self._config)

    def public_view(self) -> dict[str, Any]:
        """Config as announced to server/clients — secrets stripped."""
        view = {k: v for k, v in self._config.items() if k not in ("apiKey", "tpu")}
        return view

    @property
    def tpu(self) -> TpuConfig:
        return self._tpu

    # Convenience typed accessors for the hot fields.
    @property
    def name(self) -> str:
        return self._config["name"]

    @property
    def model_name(self) -> str:
        return self._config["modelName"]

    @property
    def api_provider(self) -> str:
        return self._config["apiProvider"]

    @property
    def public(self) -> bool:
        return self._config["public"]

    @property
    def server_key(self) -> bytes:
        return bytes.fromhex(self._config["serverKey"])

    @property
    def max_connections(self) -> int:
        return self._config.get("maxConnections", 10)

    @property
    def data_collection_enabled(self) -> bool:
        return bool(self._config.get("dataCollectionEnabled", False))


def default_config_path() -> str:
    """~/.config/symmetry/provider.yaml (reference: src/symmetry.ts:13-17)."""
    return os.path.join(
        os.path.expanduser("~"), ".config", "symmetry", "provider.yaml"
    )


def write_default_config(path: str, *, name: str, server_key_hex: str,
                         model_name: str = "llama3:8b") -> None:
    """Scaffold a provider.yaml (reference: install.sh:35-50)."""
    import yaml

    cfg = {
        "name": name,
        "public": True,
        "serverKey": server_key_hex,
        "modelName": model_name,
        "apiProvider": "tpu_native",
        "maxConnections": 10,
        "dataCollectionEnabled": False,
        "path": os.path.dirname(os.path.expanduser(path)),
        "tpu": {"mesh": {"data": 1, "model": 1}, "dtype": "bfloat16"},
    }
    os.makedirs(os.path.dirname(os.path.expanduser(path)), exist_ok=True)
    with open(os.path.expanduser(path), "w", encoding="utf-8") as fh:
        yaml.safe_dump(cfg, fh, sort_keys=False)
