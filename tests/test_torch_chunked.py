"""Chunked prefill, the radix prefix cache and from_tpu_config in the
PyTorch port (CPU, float32).

- Chunked greedy tokens against the JAX engine's chunked run on the same
  weights (converted with params_from_numpy), on `tiny` and `tiny-gemma`,
  dense and with int8 weights and an int8 KV cache: through each package's
  Scheduler, and a long prompt chunked alongside an active decode stream
  (tests/test_engine.py). Chunks run the continuation path on both sides,
  so they are held against JAX chunks, not against the port's flash path
  (the summation order differs).
- The prefix cache on against off: identical greedy and seeded streams on
  exact, partial, sub-prefix, long-suffix (seeded chunked) and coalesced
  hits (tests/test_prefix_cache.py), also where a chunk or a cached suffix
  runs its pad tokens past the bucket's capacity.
- from_tpu_config on the default TpuConfig, its refusals, the
  speculative knob and a missing checkpoint.
"""

import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from symmetry_tpu.engine.engine import EngineError as JaxEngineError
from symmetry_tpu.engine.engine import InferenceEngine as JaxEngine
from symmetry_tpu.engine.engine import SamplingParams as JaxSampling
from symmetry_tpu.engine.scheduler import GenRequest as JaxRequest
from symmetry_tpu.engine.scheduler import Scheduler as JaxScheduler
from symmetry_tpu.engine.tokenizer import ByteTokenizer as JaxByteTokenizer
from symmetry_tpu.models import forward as jax_forward
from symmetry_tpu.models import init_cache as jax_init_cache
from symmetry_tpu.models import init_params as jax_init_params
from symmetry_tpu.models import preset as jax_preset
from symmetry_tpu.models.llama import quantize_params as jax_quantize_params
from symmetry_tpu.provider.config import TpuConfig as JaxTpuConfig
from symmetry_tpu_torch.convert import params_from_numpy
from symmetry_tpu_torch.engine.engine import (
    EngineError,
    InferenceEngine,
    SamplingParams,
)
from symmetry_tpu_torch.engine.safetensors_io import CheckpointError
from symmetry_tpu_torch.engine.scheduler import GenRequest, Scheduler
from symmetry_tpu_torch.engine.spec import SpecConfig
from symmetry_tpu_torch.engine.tokenizer import ByteTokenizer
from symmetry_tpu_torch.models.llama import preset
from symmetry_tpu_torch.ops.quant import PackedQuantizedTensor
from symmetry_tpu_torch.provider.config import TpuConfig

ID_BASE = 0x4E00


def weights(name, int8=False, seed=0):
    """The JAX params of preset `name` (int8 leaves if asked) and the same
    weights as the port's dict."""
    jparams = jax_init_params(jax_preset(name), jax.random.key(seed),
                              jnp.float32)
    if int8:
        jparams = jax_quantize_params(jparams)
    params = params_from_numpy(jax.tree.map(np.asarray, jparams),
                               device="cpu")
    return jparams, params


@pytest.fixture(scope="module")
def tiny():
    return weights("tiny")


class JaxIdTokenizer(JaxByteTokenizer):
    def decode(self, ids):
        return "".join(chr(ID_BASE + i) for i in ids
                       if i not in (self.BOS, self.EOS))


class IdTokenizer(ByteTokenizer):
    def decode(self, ids):
        return "".join(chr(ID_BASE + i) for i in ids
                       if i not in (self.BOS, self.EOS))


def serve(scheduler, request_cls, sampling_cls, prompts, max_new):
    """Greedy streams of `prompts` as (token ids, finish reason)."""
    events = {i: [] for i in range(len(prompts))}
    done = {i: threading.Event() for i in range(len(prompts))}
    for i, ids in enumerate(prompts):
        def emit(ev, i=i):
            events[i].append(ev)
            if ev.done:
                done[i].set()
        scheduler.submit(request_cls(prompt_ids=list(ids),
                                     sampling=sampling_cls(),
                                     max_new_tokens=max_new, emit=emit,
                                     id=f"r{i}"))
    scheduler.start()
    try:
        for ev in done.values():
            assert ev.wait(180), "request did not complete"
    finally:
        scheduler.stop()
    return [([ord(c) - ID_BASE for c in "".join(ev.text for ev in events[i])],
             events[i][-1].finish_reason) for i in range(len(prompts))]


# ---------------------------------------------------------------------------
# Chunked prefill against the JAX engine's chunked run


CHUNK_KW = dict(max_slots=2, max_seq_len=128, prefill_buckets=(16, 32, 64),
                decode_block=4, prefill_chunk=16)


class TestChunkedParity:
    @pytest.mark.parametrize("int8", [False, True])
    @pytest.mark.parametrize("name", ["tiny", "tiny-gemma"])
    def test_scheduler_greedy_identical_to_jax(self, name, int8):
        jparams, params = weights(name, int8=int8)
        rng = np.random.default_rng(7)
        prompts = [rng.integers(0, 500, n).tolist() for n in (5, 27, 50)]
        jengine = JaxEngine(jax_preset(name), jparams, JaxIdTokenizer(512),
                            cache_dtype=jnp.float32, kv_quant=int8,
                            fused_dequant=int8, **CHUNK_KW)
        jsched = JaxScheduler(jengine, debug_invariants=True)
        want = serve(jsched, JaxRequest, JaxSampling, prompts, 10)
        engine = InferenceEngine(preset(name), params, IdTokenizer(512),
                                 cache_dtype=torch.float32, kv_quant=int8,
                                 fused_dequant=int8, device="cpu",
                                 **CHUNK_KW)
        assert engine.wants_chunked(27) and not engine.wants_chunked(16)
        sched = Scheduler(engine, debug_invariants=True)
        got = serve(sched, GenRequest, SamplingParams, prompts, 10)
        assert got == want
        assert sched.metrics["chunk_dispatches"] == 2 + 4
        assert jsched.metrics["chunk_dispatches"] == 2 + 4

    @pytest.mark.parametrize("int8", [False, True])
    @pytest.mark.parametrize("name", ["tiny", "tiny-gemma"])
    def test_chunked_alongside_active_decode(self, name, int8):
        """A prompt built chunk by chunk between decode steps of another
        slot: both streams equal the JAX engine's under the same calls."""
        jparams, params = weights(name, int8=int8, seed=1)
        pa = list(b"short")
        pb = list(b"a fairly long prompt that spans several chunks!")

        def drive(engine, sampling_cls):
            got_a = [engine.prefill_and_insert(0, pa, sampling_cls())]
            got_a.append(int(engine.decode_step()[0]))
            job = engine.start_chunked_prefill(1, pb, sampling_cls())
            assert job.n_chunks == 3
            assert engine.advance_chunked_prefill(job) is None
            got_a.append(int(engine.decode_step()[0]))
            assert engine.advance_chunked_prefill(job) is None
            got_a.append(int(engine.decode_step()[0]))
            got_b = [engine.advance_chunked_prefill(job)]
            for _ in range(3):
                toks = engine.decode_step()
                got_a.append(int(toks[0]))
                got_b.append(int(toks[1]))
            return got_a, got_b

        kw = dict(max_slots=2, max_seq_len=64, prefill_buckets=(16, 64),
                  prefill_chunk=16, kv_quant=int8)
        want = drive(JaxEngine(jax_preset(name), jparams,
                               JaxByteTokenizer(512),
                               cache_dtype=jnp.float32, **kw), JaxSampling)
        got = drive(InferenceEngine(preset(name), params, ByteTokenizer(512),
                                    cache_dtype=torch.float32, device="cpu",
                                    **kw), SamplingParams)
        assert got == want


# ---------------------------------------------------------------------------
# The radix prefix cache: on against off


BASE = list(b"hello world prefix!")  # 19 tokens -> 2 whole blocks of 8


def make_engine(params, cache_mb=16, chunk=8, buckets=(16, 32), block=8,
                slots=4, kv_quant=False):
    return InferenceEngine(
        preset("tiny"), params, ByteTokenizer(512), max_slots=slots,
        max_seq_len=64, prefill_buckets=buckets, cache_dtype=torch.float32,
        prefill_chunk=chunk, prefix_cache_bytes=cache_mb * 2**20,
        prefix_block_tokens=block, kv_quant=kv_quant, device="cpu")


def jax_reference_greedy(jparams, prompt_ids, n_tokens):
    """Greedy tokens of the JAX model on a fresh batch-1 cache."""
    cfg = jax_preset("tiny")
    cache = jax_init_cache(cfg, 1, 64, jnp.float32)
    logits, cache = jax_forward(jparams, cfg,
                                jnp.asarray([prompt_ids], jnp.int32), cache)
    last = jnp.argmax(logits[:, -1], -1).astype(jnp.int32)
    out = [int(last[0])]
    for _ in range(n_tokens - 1):
        logits, cache = jax_forward(jparams, cfg, last[:, None], cache)
        last = jnp.argmax(logits[:, 0], -1).astype(jnp.int32)
        out.append(int(last[0]))
    return out


def cache_off_greedy(params, prompt_ids, n_tokens, sampling=None, **kw):
    """The same prompt admitted with the cache off (a full prefill, or a
    plain chunked one), decoded in slot 0."""
    engine = make_engine(params, cache_mb=0, **kw)
    assert engine.prefix_index is None
    sampling = sampling or SamplingParams()
    if engine.wants_chunked(len(prompt_ids)):
        job = engine.start_chunked_prefill(0, prompt_ids, sampling)
        first = None
        while first is None:
            first = engine.advance_chunked_prefill(job)
    else:
        first = engine.prefill_and_insert(0, prompt_ids, sampling)
    return [first] + [int(engine.decode_step()[0])
                      for _ in range(n_tokens - 1)]


def count_dispatches(engine):
    counts = {"prefill": 0, "chunk_final": 0, "chunk_step": 0}
    for name in counts:
        real = getattr(engine, "_" + name)

        def wrapped(*a, _real=real, _name=name, **kw):
            counts[_name] += 1
            return _real(*a, **kw)

        setattr(engine, "_" + name, wrapped)
    return counts


def decode_slot(engine, slot, first, n_tokens):
    return [first] + [int(engine.decode_step()[slot])
                      for _ in range(n_tokens - 1)]


class TestPrefixCache:
    @pytest.mark.parametrize("kv_quant", [False, True])
    def test_exact_hit_skips_full_prefill(self, tiny, kv_quant):
        jparams, params = tiny
        engine = make_engine(params, kv_quant=kv_quant)
        miss = decode_slot(engine, 0, engine.prefill_and_insert(
            0, BASE, SamplingParams()), 6)
        assert miss == cache_off_greedy(params, BASE, 6, kv_quant=kv_quant)
        if not kv_quant:
            assert miss == jax_reference_greedy(jparams, BASE, 6)
        st = engine.prefix_index.stats()
        assert st["insertions"] == 1 and st["blocks_in_use"] == 2

        counts = count_dispatches(engine)
        hit = engine.prefix_lookup(BASE)
        assert hit is not None and hit.length == 16 and len(hit.blocks) == 2
        firsts = engine.prefill_and_insert_cached(
            [(1, BASE, SamplingParams())], hit)
        assert counts == {"prefill": 0, "chunk_final": 1, "chunk_step": 0}
        assert decode_slot(engine, 1, firsts[0], 6) == miss
        st = engine.prefix_index.stats()
        assert st["hits"] == 1 and st["tokens_reused"] == 16

    def test_partial_hit_suffix_only(self, tiny):
        _, params = tiny
        engine = make_engine(params)
        engine.prefill_and_insert(0, BASE, SamplingParams())
        other = BASE[:16] + list(b"XYZ")
        counts = count_dispatches(engine)
        hit = engine.prefix_lookup(other)
        assert hit is not None and hit.length == 16
        firsts = engine.prefill_and_insert_cached(
            [(1, other, SamplingParams())], hit)
        assert counts["prefill"] == 0 and counts["chunk_final"] == 1
        assert decode_slot(engine, 1, firsts[0], 6) == cache_off_greedy(
            params, other, 6)

    def test_unaligned_sub_prefix_hits_and_extends_tree(self, tiny):
        _, params = tiny
        engine = make_engine(params)
        engine.prefill_and_insert(0, BASE, SamplingParams())
        other = BASE[:13] + list(b"XYZ")  # 16 tokens, shares 13
        hit = engine.prefix_lookup(other)
        assert hit is not None and hit.length == 8
        firsts = engine.prefill_and_insert_cached(
            [(1, other, SamplingParams())], hit)
        assert decode_slot(engine, 1, firsts[0], 4) == cache_off_greedy(
            params, other, 4)
        assert engine.prefix_index.covers(other[:16])

    @pytest.mark.parametrize("kv_quant", [False, True])
    def test_long_suffix_runs_seeded_chunked(self, tiny, kv_quant):
        _, params = tiny
        engine = make_engine(params, kv_quant=kv_quant)
        engine.prefill_and_insert(0, BASE, SamplingParams())
        prompt = BASE[:8] + list(b"different tail..")  # 24 tok, suffix 16
        hit = engine.prefix_lookup(prompt)
        assert hit is not None and hit.length == 8
        assert engine.seeded_chunk_ok(len(prompt))
        counts = count_dispatches(engine)
        job = engine.start_chunked_prefill(1, prompt, SamplingParams(),
                                           hit=hit)
        assert job.start_pos == 8 and job.suffix_len == 16
        first = None
        while first is None:
            first = engine.advance_chunked_prefill(job)
        assert counts["prefill"] == 0 and counts["chunk_step"] == 1
        assert decode_slot(engine, 1, first, 4) == cache_off_greedy(
            params, prompt, 4, kv_quant=kv_quant)
        assert engine.prefix_index.covers(prompt[:24])
        assert engine.prefix_index.stats()["blocks_in_use"] == 4

    def test_coalesced_hit_group_with_pad_rows(self, tiny):
        _, params = tiny
        engine = make_engine(params)
        engine.prefill_and_insert(0, BASE, SamplingParams())
        prompts = [BASE[:16] + list(b"A%d" % i) for i in range(3)]
        hit = engine.prefix_lookup(prompts[0])
        firsts = engine.prefill_and_insert_cached(
            [(i, p, SamplingParams()) for i, p in enumerate(prompts)], hit)
        gots = [[f] for f in firsts]
        for _ in range(2):
            toks = engine.decode_step()
            for i in range(3):
                gots[i].append(int(toks[i]))
        assert gots == [cache_off_greedy(params, p, 3) for p in prompts]

    def test_seeded_sampling_identical_cache_on_off(self, tiny):
        _, params = tiny
        sp = SamplingParams(temperature=0.9, top_p=0.95, seed=42)
        want = cache_off_greedy(params, BASE, 6, sampling=sp)
        engine = make_engine(params)
        engine.prefill_and_insert(0, BASE, SamplingParams(seed=7))
        hit = engine.prefix_lookup(BASE)
        assert hit is not None
        firsts = engine.prefill_and_insert_cached([(1, BASE, sp)], hit)
        assert decode_slot(engine, 1, firsts[0], 6) == want

    def test_seeded_chunk_past_capacity(self, tiny):
        """A 32-token prompt in the 32 bucket, hit at 8, chunks of 16: the
        last chunk's pad tokens run 8 positions past the capacity while
        its last real token writes position 31."""
        _, params = tiny
        kw = dict(chunk=16)
        engine = make_engine(params, **kw)
        engine.prefill_and_insert(0, BASE[:8] + [1] * 4, SamplingParams())
        prompt = BASE[:8] + list(range(200, 224))
        hit = engine.prefix_lookup(prompt)
        assert hit is not None and hit.length == 8
        job = engine.start_chunked_prefill(1, prompt, SamplingParams(),
                                           hit=hit)
        assert job.start_pos + job.n_chunks * 16 == 40
        first = None
        while first is None:
            first = engine.advance_chunked_prefill(job)
        assert decode_slot(engine, 1, first, 4) == cache_off_greedy(
            params, prompt, 4, **kw)

    def test_cached_suffix_past_capacity(self, tiny):
        """A 32-token prompt hit at 24 in the 32 bucket: the 16-wide suffix
        dispatch writes positions 24..39, the last real one at 31."""
        _, params = tiny
        kw = dict(chunk=16)
        prompt = list(range(100, 132))
        engine = make_engine(params, **kw)
        engine.prefill_and_insert(0, prompt[:24] + [1], SamplingParams())
        hit = engine.prefix_lookup(prompt)
        assert hit is not None and hit.length == 24
        firsts = engine.prefill_and_insert_cached(
            [(1, prompt, SamplingParams())], hit)
        assert decode_slot(engine, 1, firsts[0], 4) == cache_off_greedy(
            params, prompt, 4, **kw)

    def test_warmup_then_hit_path(self, tiny):
        _, params = tiny
        engine = make_engine(params)
        engine.warmup()
        assert engine.prefix_index.stats()["blocks_in_use"] == 0
        engine.prefill_and_insert(0, BASE, SamplingParams())
        hit = engine.prefix_lookup(BASE)
        firsts = engine.prefill_and_insert_cached(
            [(1, BASE, SamplingParams())], hit)
        assert decode_slot(engine, 1, firsts[0], 4) == cache_off_greedy(
            params, BASE, 4)

    def test_scheduler_cache_on_equals_off(self, tiny):
        """Two waves through the Scheduler, the second sharing the first's
        prefixes: identical streams with the cache on and off, and the
        hits show in stats()."""
        _, params = tiny
        rng = np.random.default_rng(3)
        wave1 = [rng.integers(0, 500, n).tolist() for n in (19, 30, 12)]
        wave2 = [wave1[0][:16] + [7, 8], wave1[1][:24] + [9],
                 wave1[1][:16] + rng.integers(0, 500, 12).tolist()]

        def run(cache_mb):
            engine = InferenceEngine(
                preset("tiny"), params, IdTokenizer(512), max_slots=3,
                max_seq_len=64, prefill_buckets=(16, 32),
                cache_dtype=torch.float32, prefill_chunk=8,
                prefix_cache_bytes=cache_mb * 2**20, prefix_block_tokens=8,
                decode_block=4, device="cpu")
            engine.warmup()
            out, stats = [], None
            for wave in (wave1, wave2):
                sched = Scheduler(engine, debug_invariants=True)
                out += serve(sched, GenRequest, SamplingParams, wave, 6)
                stats = sched.stats()
            return out, stats

        on, stats_on = run(16)
        off, stats_off = run(0)
        assert on == off
        assert stats_on["prefix_cache"]["hits"] >= 2
        assert stats_on["prefix_cache"]["tokens_reused"] > 0
        assert "prefix_cache" not in stats_off


# ---------------------------------------------------------------------------
# from_tpu_config


class TestFromTpuConfig:
    def test_default_section_builds(self):
        engine = InferenceEngine.from_tpu_config(TpuConfig(), device="cpu")
        assert engine.prefill_chunk == 256 and engine.decode_block == 16
        assert engine.max_slots == 8 and engine.max_seq_len == 2048
        assert engine.prefill_buckets == (128, 512, 2048)
        assert engine.config == preset("tiny")
        assert engine.cache_dtype == torch.bfloat16
        assert engine.prefix_index is None and engine.prefix_align == 128
        assert engine.device == torch.device("cpu")

    def test_geometry_matches_jax(self):
        """The same tpu: section gives both packages' engines the same
        slots, buckets, chunk, block and prefix pool."""
        raw = {"prefix_cache_mb": 1, "prefill_chunk": 64,
               "prefill_buckets": [64, 128], "max_seq_len": 256,
               "max_batch_size": 2, "decode_block": 4, "dtype": "float32"}
        port = InferenceEngine.from_tpu_config(TpuConfig.from_dict(raw),
                                               device="cpu")
        jax_eng = JaxEngine.from_tpu_config(JaxTpuConfig.from_dict(raw))
        for attr in ("max_slots", "max_seq_len", "prefill_buckets",
                     "prefill_chunk", "decode_block", "prefix_align",
                     "prefix_block", "prefill_token_budget"):
            assert getattr(port, attr) == getattr(jax_eng, attr), attr
        assert port.block_pool.n_blocks == jax_eng.block_pool.n_blocks
        assert port.kv_bytes_per_token() == jax_eng.kv_bytes_per_token()

    def test_int8_section(self):
        cfg = TpuConfig.from_dict({"quantization": "int8",
                                   "kv_quantization": "int8",
                                   "fused_dequant": True,
                                   "dtype": "float32"})
        engine = InferenceEngine.from_tpu_config(cfg, device="cpu")
        assert isinstance(engine.params["lm_head"], PackedQuantizedTensor)
        assert engine.state.cache.k.dtype == torch.int8

    def test_weights_from_seed_zero(self):
        a = InferenceEngine.from_tpu_config(TpuConfig(), device="cpu")
        b = InferenceEngine.from_tpu_config(TpuConfig(), device="cpu")
        assert torch.equal(a.params["layers"]["wq"],
                           b.params["layers"]["wq"])

    @pytest.mark.parametrize("raw,item", [
        # the model axis serves since item 14's TP half
        # (tests/test_torch_tp.py); the rest stays refused, before any
        # process group is joined
        ({"mesh": {"data": 2, "model": 1}}, "item 14"),
        ({"mesh": {"data": 1, "model": 2, "context": 2}}, "item 14"),
        ({"multihost": {"coordinator": "localhost:1", "num_processes": 2,
                        "dcn_data": 2}}, "item 14"),
        ({"pipeline_microbatches": 2}, "item 14"),
    ])
    def test_refuses_knobs_outside_the_slice(self, raw, item):
        with pytest.raises(EngineError, match=item):
            InferenceEngine.from_tpu_config(TpuConfig.from_dict(raw),
                                            device="cpu")

    @pytest.mark.parametrize("raw,contract", [
        ({"role": "prefill"}, None),
        ({"role": "decode"}, "prefix cache"),
        ({"role": "decode", "prefix_cache_mb": 1}, None),
        ({"role": "disagg"}, "unknown engine role"),
        ({"profile_sample": 4}, None),
    ])
    def test_role_and_profile_sample_as_the_jax_engine(self, raw, contract):
        """tpu.role and tpu.profile_sample (once refused as items 11 and
        12) pass through from_tpu_config as in the JAX engine: the same
        sections build or raise the same contract, and a decode tier's
        pool is the JAX engine's size."""
        if contract is not None:
            with pytest.raises(EngineError, match=contract):
                InferenceEngine.from_tpu_config(TpuConfig.from_dict(raw),
                                                device="cpu")
            with pytest.raises(JaxEngineError, match=contract):
                JaxEngine.from_tpu_config(JaxTpuConfig.from_dict(raw))
            return
        port = InferenceEngine.from_tpu_config(TpuConfig.from_dict(raw),
                                               device="cpu")
        jax_eng = JaxEngine.from_tpu_config(JaxTpuConfig.from_dict(raw))
        assert port.role == jax_eng.role == raw.get("role", "unified")
        assert (port.devprof.sample_every == jax_eng.devprof.sample_every
                == raw.get("profile_sample", 0))
        if port.block_pool is not None:
            assert port.block_pool.n_blocks == jax_eng.block_pool.n_blocks

    @pytest.mark.parametrize("knob,k_draft", [
        (True, SpecConfig().k_draft), ({"k_draft": 4}, 4), (3, 3)])
    def test_speculative_builds_a_verifying_engine(self, knob, k_draft):
        """tpu.speculative (once refused as item 7) parses through
        SpecConfig.from_knob into engine.spec, as the JAX engine's."""
        engine = InferenceEngine.from_tpu_config(TpuConfig.from_dict(
            {"speculative": knob}), device="cpu")
        assert engine.spec == SpecConfig.from_knob(knob)
        assert engine.spec.k_draft == k_draft
        engine.prefill_and_insert(0, [1, 2, 3], SamplingParams())
        draft = np.zeros((engine.max_slots, k_draft), np.int64)
        toks, n_emit = engine.verify_step(draft, np.zeros(
            (engine.max_slots,), np.int32))
        assert toks.shape == (1 + k_draft, engine.max_slots)
        assert (n_emit >= 1).all()

    def test_missing_checkpoint_raises_checkpoint_error(self):
        """checkpoint_path (once refused as item 10) loads; a directory
        that is not there raises CheckpointError naming it, never random
        weights."""
        with pytest.raises(CheckpointError, match="/nonexistent/ckpt"):
            InferenceEngine.from_tpu_config(TpuConfig.from_dict(
                {"checkpoint_path": "/nonexistent/ckpt"}), device="cpu")

    def test_card_is_the_default(self, monkeypatch):
        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
        with pytest.raises(EngineError, match="no CUDA device"):
            InferenceEngine.from_tpu_config(TpuConfig())

    def test_rejects_bad_dtype_and_quantization(self):
        for raw in ({"dtype": "int4"}, {"quantization": "int4"},
                    {"kv_quantization": "fp8"}):
            with pytest.raises(EngineError):
                InferenceEngine.from_tpu_config(TpuConfig.from_dict(raw),
                                                device="cpu")
